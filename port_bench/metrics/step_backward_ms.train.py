"""step_backward_ms.train: device ms of a supervised step's backward phase, from the
program's phase marks."""
from port_bench.span_readers import step_backward_ms as read  # noqa: F401
