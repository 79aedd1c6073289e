"""The GEMV routes' roofline shares over the traced span (shared by
``gemv_decode_roofline`` and ``gemv_tc_roofline``)."""

from servebench import costs


def _step_cost(run, step):
    """Bound seconds and launches of each route in one step: a decode step
    runs every linear at M = lanes on the decode route; a chunk step runs
    every layer linear at M = lanes x chunk on the tensor-core route and
    the head at M = lanes on the decode route."""
    model, bits = run.model, run.engine["weight_bits"]
    lanes, chunk = run.serve["lanes"], run.serve["prefill_chunk"]
    layer = [(k, n) for _, k, n in costs.layer_linears(model)]
    head = [costs.head_linear(model)[1:]]
    n_layers = model["n_layers"]

    def bound(m, shapes):
        return sum(costs.bound_s(costs.bitplane_gemv(m, k, n, bits, 2, 2))
                   for k, n in shapes)

    out = {"decode": [0.0, 0], "tensor_core": [0.0, 0]}
    if step.decode:
        out["decode"][0] += n_layers * bound(lanes, layer) + bound(lanes, head)
        out["decode"][1] += n_layers * len(layer) + 1
    if step.chunk:
        out["tensor_core"][0] += n_layers * bound(lanes * chunk, layer)
        out["tensor_core"][1] += n_layers * len(layer)
        out["decode"][0] += bound(lanes, head)
        out["decode"][1] += 1
    return out


def share(run, route):
    """100 x the route's bound seconds over its kernel seconds, over the
    span's steps whose every launch of the route the trace holds; None
    when no step ran the route, or when the launches the port counted over
    the span are not the ones its steps make (the bound would price other
    work than was timed)."""
    p = run.profile
    if not p.get("step_routes"):
        return None
    costs_ = [_step_cost(run, s)[route] for s in p["steps"]]
    if p["counted"].get(f"bitplane_gemv/{route}") != sum(c[1] for c in
                                                          costs_):
        return None
    bound = seconds = 0.0
    for (b, launches), seen in zip(costs_, p["step_routes"]):
        if launches and seen[route]["launches"] == launches:
            bound += b
            seconds += seen[route]["seconds"]
    return 100.0 * bound / seconds if seconds > 0 else None
