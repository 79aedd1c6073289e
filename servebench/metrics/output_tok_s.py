"""Output tokens a second: every token that arrived in the window over the
window's seconds."""


def read(run):
    return len(run.stamps()) / run.seconds
