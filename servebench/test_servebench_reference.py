"""The plain reference against the port's plain CPU engine at the reduced
sizes of the registry entries (the dense family's two, and the moe
family's with and without a shared expert): the full-sequence forward
with the same packed weights, the int8 K/V rounding, and a whole served
run in float32 (where the widest gap is rounding) and in bfloat16."""

import pytest
import torch

from servebench import harness, testing
from servebench.reference import draw
from servebench.reference import model as reference

SEED = 2 ** 31 + 77


def tiny_conf(name, dtype):
    if name in testing.TINY_MOE:
        return testing.tiny_moe(name, dtype)
    return testing.tiny_model(name, dtype)


# float32 on both sides: what differs is the order of the sums (2e-4 on
# logits of about 1-3), and a near tie of the top token; a moe layer's
# routing is float32 too, so a pair flips only on a tie within rounding
@pytest.mark.parametrize("name", sorted(testing.TINY_MODELS)
                         + sorted(testing.TINY_MOE))
def test_reference_equals_the_ports_forward(name):
    from repro_torch.config.base import EngineConfig
    from repro_torch.engine import resolve_plan
    from repro_torch.models import forward

    conf = tiny_conf(name, "float32")
    family = harness.family_of(testing.REPO, conf)
    cfg = harness.port_config(conf)
    m = conf["model"]
    params = family.build_params(cfg, m, 4, SEED, "cpu")
    tokens = torch.randint(0, m["vocab_size"], (1, 40),
                           generator=torch.Generator().manual_seed(5))
    plan = resolve_plan(EngineConfig(weight_bits=4, **testing.CPU_ENGINE),
                        device=torch.device("cpu"))
    logits, _ = forward(params, {"tokens": tokens}, cfg, plan,
                        attn_backend="gather")
    logits = logits[0].double()
    seq = tokens[0].tolist()
    ref = family.score(m, {"weight_bits": 4, "kv_bits": 0}, SEED, [seq],
                       [range(0, 39)], "cpu")[0]
    best, top = logits[:39].max(dim=-1)
    torch.testing.assert_close(ref["best"].double(), best, atol=2e-4,
                               rtol=1e-4)
    assert (ref["top"] == top).float().mean() > 0.95
    nxt = logits[torch.arange(39), tokens[0, 1:]]
    torch.testing.assert_close(ref["next_logit"].double(), nxt, atol=2e-4,
                               rtol=1e-4)


def test_kv_rounding_is_the_ports():
    from repro_torch.models.transformer import _quantize_kv

    t = torch.randn(33, 2, 16, generator=torch.Generator().manual_seed(3))
    q, scale = _quantize_kv(t)
    port = q.float() * scale.to(torch.bfloat16).float()[..., None]
    torch.testing.assert_close(reference.kv_rounded(t), port, atol=0,
                               rtol=0)


def test_weights_are_drawn_alike_and_differ_by_seed():
    m = testing.tiny_model("tiny-gelu")["model"]
    a = draw.draw_layer(m, SEED, 1, "cpu")
    b = draw.draw_layer(m, SEED, 1, "cpu")
    c = draw.draw_layer(m, SEED + 1, 1, "cpu")
    assert set(a) == {"ln1", "wq", "wk", "wv", "wo", "ln2", "w_up", "w_down"}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["wq"], c["wq"])
    assert a["wq"].dtype == torch.bfloat16
    assert float(a["wq"].float().std()) == pytest.approx(
        m["d_model"] ** -0.5, rel=0.1)


def test_dequantized_codes():
    from repro_torch.core.quantize import quantize_symmetric

    w = torch.tensor([[0.7, -1.0], [0.35, 0.5], [-0.7, 0.25]])
    # column 0: scale 0.1, codes 7, 4 (3.5 to even), -7
    torch.testing.assert_close(reference.dequantized(w, 4)[:, 0],
                               torch.tensor([0.7, 0.4, -0.7]))
    g = torch.Generator().manual_seed(9)
    for bits in (2, 4, 8):
        w = torch.randn(96, 40, generator=g).to(torch.bfloat16)
        q, scale = quantize_symmetric(w, bits, axis=0)
        assert torch.equal(reference.dequantized(w, bits),
                           q.float() * scale)


# in float32 the gap is what rounding the reference does not follow: the
# order of the sums
@pytest.mark.parametrize("dtype,bound", [("float32", 0.01),
                                         ("bfloat16",
                                          testing.TINY_LIMITS["max_gap"])])
def test_served_run_against_the_reference(tmp_path, dtype, bound):
    root = testing.make_root(tmp_path, dtype=dtype)
    out = testing.run_tiny(root, "tiny-swiglu.mix")
    check = out["result"]["check"]
    assert out["result"]["correct"]
    assert check["served_requests"]["value"] >= 3
    assert out["info"]["compared_tokens"] >= 40
    assert check["max_gap"]["value"] < bound
