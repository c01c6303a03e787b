"""step_update_ms.train: device ms of a supervised step's update phase (norm and clip,
kernel #5, EMA, the non-finite counter), from the program's phase marks."""
from port_bench.span_readers import step_update_ms as read  # noqa: F401
