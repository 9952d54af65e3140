"""The general traffic generator: one closed-loop caller.

A traffic mix is a data file (``traffic/<mix>.json``) whose ``kind`` names
the runner that reads it, ``kinds/<kind>.py`` under the benchmark's paths
(``registry.kind``), and whose other keys are that runner's parameters.
A kind's module holds a class ``Calls``, built as
``Calls(mix, config, seed, device, spans)``, which offers:

- ``sync_spans``: whether a traced run's spans wait for the device;
- ``setup_targets()``, ``window_targets()``: the (owner, attribute, span)
  triples the spans wrap in set-up and in the window;
- ``set_up(adj)``, ``warm_up()``: the program's set-up and one warm-up call;
- ``call()``: one whole call, returning its work (edges x iterations, or
  one estimate);
- ``facts()``, ``counters()``: what the metric readers need of the program,
  and its launch counters;
- ``program_check_steps()``, ``release()``, ``check(steps, control)``: the
  program's answers for the check, the program's state freed, and the
  compared numbers ({name: value}, the control's under ``control.<name>``),
  with ``notes`` ({name: value}) printed beside them.

Every kind is driven the same way: set-up, one warm-up call, then whole
calls back to back, the next one sent when the last returns, until
``seconds`` have passed (the last call is always let finish); in a traced
run, ``traced_calls`` calls under the profiler instead.
"""

import time


def closed_loop(call, seconds=None, calls=None):
    """Whole calls back to back for ``seconds`` (or ``calls`` of them):
    {'calls', 'work', 'seconds', 'call_seconds'}, the seconds from the
    first call's start to the end of the last, and each call's."""
    work, done, each = 0, 0, []
    t0 = last = time.perf_counter()
    while True:
        work += call()
        done += 1
        now = time.perf_counter()
        each.append(now - last)
        last = now
        t = now - t0
        if (calls is not None and done >= calls) or (
                calls is None and t >= seconds):
            return {"calls": done, "work": work, "seconds": t,
                    "call_seconds": each}
