"""The decode steps' share of the HBM roofline over the window, in %: the
bytes each decode step must move, as the configuration's family module
prices them (``decode_step_bytes``; the dense family's every code and
scale once, the K/V of each decoding lane at its real length, the new
K/V), summed over the window's decode steps, over their host seconds
times 3.35 TB/s.  None where a step cannot be priced."""

from servebench import costs


def read(run):
    steps = [s for s in run.steps if s.decode]
    if not steps:
        return None
    nbytes = [run.family.decode_step_bytes(
        run.model, run.engine, run.serve["lanes"], s.decode_positions, s)
        for s in steps]
    if None in nbytes:
        return None
    seconds = sum(s.decode_s for s in steps)
    return 100.0 * sum(nbytes) / (seconds * costs.PEAK_BYTES)
