"""The whole step's share of the card's bf16 peak over the window, in %:
the model FLOPs of the window's useful work (each prompt token computed
and each token a decoding lane fed, each priced at its real position by
the configuration's family module, ``token_flops``: the dense family's
linears at 2 FLOPs a parameter and its attention) over the window's
seconds times 989 TFLOP/s.  Tokens served from the cache and padded rows
do not count."""

from servebench import costs


def read(run):
    model, price = run.model, run.family.token_flops
    flops = 0
    for s in run.steps:
        for start, n in s.prefill_spans:
            flops += sum(price(model, p) for p in range(start, start + n))
        flops += sum(price(model, p) for p in s.decode_positions)
    if not flops:
        return None
    return 100.0 * flops / (run.seconds * costs.PEAK_FLOPS)
