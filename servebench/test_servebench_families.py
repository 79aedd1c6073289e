"""The family modules (``families/<name>.py``): the dense family is the
code it replaced, bit for bit; the moe family's draws and packing are the
port's, its step costs are worked out by hand, its faults read not
correct and its control fails where the program passes; and a family
imports the program only to pack the weights.  (The moe reference is
held against the port's forward in ``test_servebench_reference.py``, a
moe cell found by name in ``test_servebench_discovery.py``.)"""

import ast
import hashlib
from types import SimpleNamespace

import pytest
import torch

from servebench import costs, harness, testing
from servebench.client import StepRecord
from servebench.reference import draw

SEED = 2 ** 31 + 77
FAMILIES = testing.REPO / "servebench" / "families"


def family(name):
    return harness.family_module(testing.REPO, name)


def tree_digest(tree) -> str:
    """sha256 over a params tree: every tensor's path, dtype, shape and
    bytes, and a packed linear's fields, in key order."""
    h = hashlib.sha256()

    def walk(path, v):
        if isinstance(v, dict):
            for k in sorted(v):
                walk(f"{path}/{k}", v[k])
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                walk(f"{path}/{i}", x)
        elif torch.is_tensor(v):
            h.update(f"{path}:{v.dtype}:{tuple(v.shape)}".encode())
            raw = v.contiguous()
            raw = raw.view(torch.int16) if v.dtype == torch.bfloat16 else raw
            h.update(raw.view(torch.uint8).numpy().tobytes())
        elif v is None or isinstance(v, (int, float, str)):
            h.update(f"{path}={v!r}".encode())
        else:
            for f in ("packed", "scale", "bias", "bits", "in_features",
                      "out_features", "partition", "shard"):
                walk(f"{path}.{f}", getattr(v, f))

    walk("", tree)
    return h.hexdigest()


# ---------------------------------------------------------------- dense
# digests of the tiny dense params and of reference.score's records, taken
# on the tree before the family modules (harness.build_params and
# reference.model.score called directly), one CPU thread
FROZEN = {
    "tiny-gelu": (
        "b6db5dc2ec4ea724bc7c3f7d4718e08305ea4ae683ba14323652abf041ec8f4a",
        "848f3d44bfb4b4d91c009b9318cdf8321bf3c9826b1194190f4a27dea771df75"),
    "tiny-swiglu": (
        "9711a9730d197cc76369162a6c64d75256dca1c3f61cf033de1e9f8ad3ef3499",
        "f472cb2a968f8a65812d2f53afce040ef6fb5f74aa3138c4ac458a34c32b27db"),
}


@pytest.mark.parametrize("name", sorted(FROZEN))
def test_dense_family_is_the_code_it_replaced(name):
    conf = testing.tiny_model(name)
    fam = harness.family_of(testing.REPO, conf)
    assert fam.__file__ == str(FAMILIES / "dense.py")   # model.family
    m = conf["model"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        params = fam.build_params(harness.port_config(conf), m, 4, SEED,
                                  "cpu")
        g = torch.Generator().manual_seed(5)
        seqs = [torch.randint(0, m["vocab_size"], (n,), generator=g).tolist()
                for n in (40, 23)]
        out = fam.score(m, {"weight_bits": 4, "kv_bits": 8}, SEED, seqs,
                        [range(5, 39), range(0, 22)], "cpu",
                        keep=[[5, 17, 38], [0, 21]],
                        extra=[[1] * 34, [2] * 22])
    finally:
        torch.set_num_threads(threads)
    h = hashlib.sha256()
    for rec in out:
        for k in sorted(rec):
            h.update(k.encode())
            h.update(rec[k].contiguous().numpy().tobytes())
    assert (tree_digest(params), h.hexdigest()) == FROZEN[name]


def test_dense_prices_are_the_cost_modules(tmp_path, monkeypatch):
    """On a tiny dense run, ``mfu`` and ``decode_hbm_share`` read what
    ``costs.py`` gives for the window's steps."""
    from servebench import window

    runs = []
    init = window.Run.__init__

    def keep(self, *a, **k):
        init(self, *a, **k)
        runs.append(self)
    monkeypatch.setattr(window.Run, "__init__", keep)
    root = testing.make_root(tmp_path)
    out = testing.run_tiny(root, "tiny-swiglu.mix", trace=True)
    run, metrics = runs[0], out["result"]["metrics"]
    m, e = run.model, run.engine
    flops = sum(costs.token_flops(m, p) for s in run.steps
                for start, n in s.prefill_spans
                for p in range(start, start + n))
    flops += sum(costs.token_flops(m, p) for s in run.steps
                 for p in s.decode_positions)
    assert metrics["mfu"]["value"] == 100.0 * flops / (
        run.seconds * costs.PEAK_FLOPS)
    steps = [s for s in run.steps if s.decode]
    nbytes = sum(costs.decode_step_bytes(m, e["weight_bits"], e["kv_bits"],
                                         run.serve["lanes"],
                                         s.decode_positions) for s in steps)
    assert metrics["decode_hbm_share"]["value"] == 100.0 * nbytes / (
        sum(s.decode_s for s in steps) * costs.PEAK_BYTES)
    assert all(s.experts_touched is None for s in run.steps)


# ------------------------------------------------------------------ moe
def test_moe_sizes_are_the_registrys_reduced():
    from repro_torch.config.registry import get_reduced

    for name, (registry, sizes) in testing.TINY_MOE.items():
        cfg = get_reduced(registry)
        assert {k: getattr(cfg, k) for k in sizes} == sizes, name
        # the capacity at which the port drops no pair
        model = testing.tiny_moe(name)["model"]
        assert model["capacity_factor"] == cfg.n_experts / cfg.top_k


def test_moe_draws_follow_the_dense_attention():
    """A layer draws the dense family's attention first (the same bits as
    ``draw_layer``), then the router and the experts in a fixed order."""
    m = testing.tiny_moe("tiny-moe-shared")["model"]
    dense = draw.draw_layer(m, SEED, 1, "cpu")
    fam = family("moe")
    a, b = fam.LayerDraws(m, SEED, 1, "cpu"), fam.LayerDraws(m, SEED, 1,
                                                             "cpu")
    att = a.attention()
    assert all(torch.equal(att[k], dense[k]) for k in att)
    b.attention()
    assert torch.equal(a.router(), b.router())
    first = [a.expert() for _ in range(m["n_experts"])]
    again = [b.expert() for _ in range(m["n_experts"])]
    assert all(torch.equal(x[k], y[k]) for x, y in zip(first, again)
               for k in x)
    assert not torch.equal(first[0]["w_gate"], first[1]["w_gate"])
    assert first[0]["w_down"].shape == (m["moe_d_ff"], m["d_model"])
    shared = a.shared()
    assert shared["w_up"].shape == (m["d_model"], m["d_ff"])
    assert float(shared["w_up"].float().std()) == pytest.approx(
        m["d_model"] ** -0.5, rel=0.15)
    no_shared = testing.tiny_moe("tiny-moe")["model"]
    assert fam.LayerDraws(no_shared, SEED, 0, "cpu").shared() is None


def test_moe_packing_is_the_ports():
    """Experts packed one at a time and stacked hold the bytes that the
    port's ``quantize_params`` gives the stacked experts."""
    from repro_torch.models import quantize_params

    conf = testing.tiny_moe("tiny-moe")
    m, cfg = conf["model"], harness.port_config(conf)
    params = family("moe").build_params(cfg, m, 4, SEED, "cpu")
    draws = family("moe").LayerDraws(m, SEED, 0, "cpu")
    draws.attention()
    router = draws.router()
    experts = [draws.expert() for _ in range(m["n_experts"])]
    stacked = quantize_params({"layers": [{"moe": {
        k: torch.stack([x[k] for x in experts])
        for k in ("w_gate", "w_up", "w_down")}}]}, cfg, 4)
    mine = params["layers"][0]["moe"]
    for k in ("w_gate", "w_up", "w_down"):
        want = stacked["layers"][0]["moe"][k]
        assert torch.equal(mine[k].packed, want.packed)
        assert torch.equal(mine[k].scale, want.scale)
        assert mine[k].in_features == want.in_features
    assert torch.equal(mine["router"]["w"], router)
    assert "shared" not in mine


def tiny_moe_model():
    return testing.tiny_moe("tiny-moe-shared")["model"]


def test_moe_token_flops_by_hand():
    m = tiny_moe_model()
    # d 64, 4 / 2 heads of 16: wq 64x64, wk / wv 64x32, wo 64x64 = 12,288;
    # router 64x4 = 256; one expert of three 64x128 = 24,576; the shared
    # SwiGLU the same; 3 layers; head 64x256 = 16,384
    params = 3 * (12_288 + 256 + 1 * 24_576 + 24_576) + 16_384
    assert family("moe").matmul_params(m) == params
    # attention at position 9: 10 keys x 4 heads x 16 x 3 layers x 4
    assert family("moe").token_flops(m, 9) == 2 * params + 4 * 10 * 64 * 3
    two = testing.tiny_moe("tiny-moe")["model"]
    # top 2 of 8 experts of three 64x96, no shared expert, d_ff unused
    assert family("moe").matmul_params(two) == (
        3 * (12_288 + 64 * 8 + 2 * 3 * 64 * 96) + 64 * 256)


def test_moe_decode_bytes_by_hand():
    m = tiny_moe_model()
    step = StepRecord(0, 1, chunk=False, decode=True, experts_touched=5)
    got = family("moe").decode_step_bytes(
        m, {"weight_bits": 4, "kv_bits": 8}, 4, [10, 20], step)
    lanes = 4
    # dense codes at 4 bits with float32 scales, bf16 x and y at M 4:
    # attention and the shared expert each layer, the head once
    dense = 0
    for k, n in ([(64, 64), (64, 32), (64, 32), (64, 64)]
                 + [(64, 128), (64, 128), (128, 64)]) * 3 + [(64, 256)]:
        dense += k * n // 2 + 4 * n + 2 * lanes * (k + n)
    router = 3 * (2 * 64 * 4 + 2 * lanes * (64 + 4))
    # 4 lanes x top 1 routed rows into and out of each grouped launch
    rows = 3 * 2 * 4 * ((64 + 128) + (64 + 128) + (128 + 64))
    # 5 touched (layer, expert) pairs, each three linears' codes and scales
    touched = 5 * (2 * (64 * 128 // 2 + 4 * 128) + 128 * 64 // 2 + 4 * 64)
    embed = lanes * 64 * 2
    # int8 K/V: 3 layers x 2 x (2 heads x 16 + 2 bf16 scales x 2 heads)
    kv = 3 * 2 * (32 + 4)
    assert got == dense + router + rows + touched + embed + (30 + 2) * kv
    none = StepRecord(0, 1, chunk=False, decode=True)
    assert family("moe").decode_step_bytes(
        m, {"weight_bits": 4, "kv_bits": 8}, 4, [10], none) is None


def test_moe_hbm_share_needs_every_steps_count():
    from servebench.window import Run

    m = tiny_moe_model()
    steps = [StepRecord(0, 1, chunk=False, decode=True, decode_s=0.01,
                        decode_positions=[9], experts_touched=3),
             StepRecord(1, 2, chunk=False, decode=True, decode_s=0.01,
                        decode_positions=[10])]
    client = SimpleNamespace(records=[], steps=steps)
    run = Run(client, {"t0": 0.0, "t1": 2.0, "first_step": 0,
                       "last_step": 2}, m, {"weight_bits": 4, "kv_bits": 8},
              {"lanes": 4, "prefill_chunk": 8}, 1.0, 0, None, family("moe"))
    read = harness.reader(testing.REPO, "decode_hbm_share")
    assert read(run) is None
    steps[1].experts_touched = 4
    fam = family("moe")
    want = sum(fam.decode_step_bytes(m, run.engine, 4, s.decode_positions, s)
               for s in steps)
    assert read(run) == pytest.approx(100 * want / (0.02 * costs.PEAK_BYTES))


# ------------------------------------------------- moe faults and control
@pytest.fixture(scope="module")
def moe_root(tmp_path_factory):
    root = testing.make_root(tmp_path_factory.mktemp("tiny"))
    for name in sorted(testing.TINY_MOE):
        testing.add_moe(root, name)
    return root


def swapped_experts(eng):
    """Experts 0 and 1 of the first layer trade codes and scales: tokens
    routed to one are computed by the other."""
    moe = eng.params["layers"][0]["moe"]
    for name in ("w_gate", "w_up", "w_down"):
        for t in (moe[name].packed, moe[name].scale):
            first = t[0].clone()
            t[0].copy_(t[1])
            t[1].copy_(first)


def dropped_shared(eng):
    """The shared expert is left out of every layer."""
    for layer in eng.params["layers"]:
        del layer["moe"]["shared"]


@pytest.mark.parametrize("cell,fault", [
    ("tiny-moe.mix", swapped_experts),
    ("tiny-moe-shared.mix", swapped_experts),
    ("tiny-moe-shared.mix", dropped_shared)],
    ids=lambda v: getattr(v, "__name__", v))
def test_moe_fault_is_caught(moe_root, cell, fault):
    sound = testing.run_tiny(moe_root, cell)
    assert sound["result"]["correct"]
    out = testing.run_tiny(moe_root, cell, hooks=fault)
    check = out["result"]["check"]
    assert not out["result"]["correct"]
    assert check["max_gap"]["value"] > check["max_gap"]["limit"]


@pytest.mark.parametrize("cell", ["tiny-moe.mix", "tiny-moe-shared.mix"])
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 5])
def test_moe_control_fails_where_the_program_passes(moe_root, cell, seed):
    out = testing.run_tiny(moe_root, cell, seed=seed, control=True)
    check = out["result"]["check"]
    program = check["logit_rms_err"]["value"]
    control = check["control_logit_rms_err"]["value"]
    assert out["result"]["correct"]
    assert program <= check["logit_rms_err"]["limit"] < control
    assert control >= 3 * program


# -------------------------------------------------------------- hygiene
@pytest.mark.parametrize("path", sorted(FAMILIES.glob("*.py")),
                         ids=lambda p: p.name)
def test_a_family_imports_the_program_only_to_pack(path):
    """The program's modules are imported inside ``build_params`` alone:
    the reference and the costs are the benchmark's own."""
    tree = ast.parse(path.read_text())

    def program_imports(node):
        return [n for n in ast.walk(node)
                if isinstance(n, ast.ImportFrom) and n.module
                and n.module.split(".")[0] == "repro_torch"
                or isinstance(n, ast.Import)
                and any(a.name.split(".")[0] == "repro_torch"
                        for a in n.names)]

    outside = list(program_imports(tree))
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == "build_params":
            for n in program_imports(node):
                outside.remove(n)
    assert not outside, path
    mod = harness.family_module(testing.REPO, path.stem)
    for fn in ("build_params", "score", "token_flops", "decode_step_bytes"):
        assert callable(getattr(mod, fn)), (path, fn)

