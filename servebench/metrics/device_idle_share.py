"""Share of the traced span in which no operation ran on the card, in %
(1 minus the union of the device intervals over the span's length)."""


def read(run):
    p = run.profile
    if not p.get("window_s"):
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
