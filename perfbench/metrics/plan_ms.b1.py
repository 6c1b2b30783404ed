"""Mean milliseconds of a repair's planning at B = 1: the ``total`` stage
of the program's ``PlannerProfile`` hook on ``plan_many``, which ends at
the device's synchronize."""


def read(rec, ctx):
    return rec.values.get("plan_total_ms")
