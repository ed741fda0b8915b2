"""Host seconds inside the port's chunk-plan functions during set-up
(``families/<family>.py PLAN_FUNCTIONS``, outermost calls, each to the
device's synchronisation)."""

LAYER = "ops plan (host)"
UNIT = "s"
MOVES = "setup_s"


def read(ctx):
    return sum(ctx["plan_s"]) if ctx["plan_s"] else None
