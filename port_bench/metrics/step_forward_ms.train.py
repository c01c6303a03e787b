"""step_forward_ms.train: device ms of a supervised step's forward phase (gather, z-norm,
pad, forward, BCE), from the program's phase marks."""
from port_bench.span_readers import step_forward_ms as read  # noqa: F401
