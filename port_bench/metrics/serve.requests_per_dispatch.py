"""serve.requests_per_dispatch: requests a MicroBatcher dispatch coalesced."""
from port_bench.readers import requests_per_dispatch as read  # noqa: F401
