"""The decode steps' share of the HBM roofline over the window, in %: the
bytes each decode step must move (``costs.decode_step_bytes``: every code
and scale once, the K/V of each decoding lane at its real length, the new
K/V) summed over the window's decode steps, over their host seconds times
3.35 TB/s."""

from servebench import costs


def read(run):
    steps = [s for s in run.steps if s.decode]
    if not steps:
        return None
    nbytes = sum(costs.decode_step_bytes(
        run.model, run.engine["weight_bits"], run.engine["kv_bits"],
        run.serve["lanes"], s.decode_positions) for s in steps)
    seconds = sum(s.decode_s for s in steps)
    return 100.0 * nbytes / (seconds * costs.PEAK_BYTES)
