"""Host utilities (the JAX package's ``utils/misc.py``): the step timer.

``StepTimer`` splits a train loop's time into input wait and step time on the
host clock.  The port dispatches steps asynchronously, as JAX does, so the
"compute" side is the time to queue a step unless something in it waits for
the device (a logged loss, a checkpoint); read it beside the device's busy
share from a profile.
"""
from __future__ import annotations

import time
from typing import Dict


class StepTimer:
    """Train-loop timer splitting step time into input vs compute wait.

    Call ``input_done()`` after the batch is ready and ``step_done()`` after
    the step returns; ``summary()`` reports the input-bound fraction (the
    counter the reference lacks entirely -- its pipeline is 100% input-bound
    by construction, dataset.py:93).
    """

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self.input_s = 0.0
        self.compute_s = 0.0
        self.steps = 0

    def input_done(self):
        now = time.perf_counter()
        self.input_s += now - self._t0
        self._t0 = now

    def step_done(self):
        now = time.perf_counter()
        self.compute_s += now - self._t0
        self._t0 = now
        self.steps += 1

    def summary(self) -> Dict[str, float]:
        total = self.input_s + self.compute_s
        return {
            'steps': self.steps,
            'input_s': round(self.input_s, 4),
            'compute_s': round(self.compute_s, 4),
            'input_fraction': round(self.input_s / total, 4) if total else 0.0,
            'steps_per_sec': round(self.steps / total, 2) if total else 0.0,
        }
