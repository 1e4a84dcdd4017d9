"""Phase spans: the one way the port's encode and decode time a phase.

``span(phases, name)`` adds the ``time.perf_counter()`` seconds of its
body to ``phases[name]``, a dict of phase seconds such as
``EncodeStats.phase_seconds``; a phase entered twice adds up. Spans nest.
While a torch profiler records, the span is also a range named
``qvz.<name>`` on the profiler's clock, so that the trace places each
phase beside the device's kernels and copies.

The range is an operator range (``_RecordFunctionFast``), not a
``torch.profiler.record_function`` range: the profiler draws a
``record_function`` range on the device's timeline too, over the kernels
launched inside it, where a reader of the device's events would count it
as device work. With no profiler the span costs a flag test, a clock pair
and a dict update.
"""

from __future__ import annotations

import contextlib
import time

import torch

PREFIX = "qvz."


@contextlib.contextmanager
def span(phases: dict, name: str):
    rng = (torch._C._profiler._RecordFunctionFast(PREFIX + name)
           if torch.autograd._profiler_enabled()
           else contextlib.nullcontext())
    with rng:
        t0 = time.perf_counter()
        yield
        phases[name] = phases.get(name, 0.0) + time.perf_counter() - t0
