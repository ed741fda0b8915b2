"""Host seconds of the BPR plan's membership and sampling tables in
set-up (unique keys, key table, sub-keys, bitmask, popularity CDF): the
port's counter ``plan.membership.seconds``
(``mymedialite_tpu_torch/trace.py``, always counted). None in another
family or where the port has no such counter."""

LAYER = "ops plan (host)"
UNIT = "s"
MOVES = "setup_s"


def read(ctx):
    if ctx["family"] != "triple":
        return None
    try:
        from mymedialite_tpu_torch import trace
    except ImportError:
        return None
    return trace.counters().get("plan.membership.seconds")
