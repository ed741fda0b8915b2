"""Host seconds of the port's chunk bucketing in set-up: its counter
``plan.bucketize.seconds`` (``mymedialite_tpu_torch/trace.py``; the
native counting sort or its NumPy fallback inside ``prepare_mxu_data``,
always counted). None where the port has no such counter."""

LAYER = "ops plan (host)"
UNIT = "s"
MOVES = "setup_s"


def read(ctx):
    try:
        from mymedialite_tpu_torch import trace
    except ImportError:
        return None
    return trace.counters().get("plan.bucketize.seconds")
