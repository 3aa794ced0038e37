"""Host self time of the host plan (``dbg.plan``, with the main thread's waits
on a worker's plan, ``dbg.plan.wait``) in ms a decoded MB (PNG)."""

from benchmark import spans


def read(run):
    return spans.ms_per_MB(run, "plan")
