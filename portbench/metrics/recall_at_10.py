"""Mean share of the reference's exact top 10 that a query's answer
holds, over every query of the window (the judge's count)."""


def read(run):
    if run.traffic.get("k") != 10 or "recall" not in run.values:
        return None
    return run.values["recall"]
