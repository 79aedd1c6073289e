"""Share of prompt tokens served from the prefix cache, in %: the cached
tokens (``Request.cached_tokens``, set by the scheduler at admission) over
the prompt tokens of every request admitted in the window."""


def read(run):
    admitted = [r for r in run.client.records
                if r.admitted is not None and run.t0 < r.admitted <= run.t1]
    prompt = sum(len(r.req.prompt) for r in admitted)
    if not prompt or run.client.eng.prefix_cache is None:
        return None
    return 100.0 * sum(r.req.cached_tokens for r in admitted) / prompt
