"""The frozen cost arithmetic: hand-worked bytes of one packed linear, the
same numbers as the port's own cost module, a model's parameters, and the
profiler summary's reading of kernel names."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from servebench import costs
from servebench.profile import kernel_label, route_of, summarize

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ("mistral-large-123b", "starcoder2-15b")


def model(name):
    return json.loads((ROOT / "servebench" / "configs"
                       / f"{name}.json").read_text())["model"]


def test_one_packed_linear_by_hand():
    # M 8, K 4096, N 1024 at 4 bits: codes K*N/2, float32 scales, bf16 x
    # and y; a multiply-add two operations
    nbytes, ops = costs.bitplane_gemv(8, 4096, 1024, 4, 2, 2)
    assert nbytes == 2_097_152 + 4_096 + 65_536 + 16_384
    assert ops == 67_108_864
    # bytes bound it: 2,183,168 B / 3.35 TB/s
    assert costs.bound_s((nbytes, ops)) == pytest.approx(6.5169e-7,
                                                         rel=1e-4)
    # at M 256 the operations do: 2 * 256 * 4096 * 1024 / 989 TFLOP/s
    assert costs.bound_s(costs.bitplane_gemv(256, 4096, 1024, 4, 2, 2)) \
        == pytest.approx(2 * 256 * 4096 * 1024 / 989e12)


@pytest.mark.parametrize("m,k,n,bits", [(8, 12288, 28672, 4),
                                        (256, 6144, 24576, 4),
                                        (1, 2048, 256, 8), (4, 64, 96, 2)])
def test_equals_the_ports_cost_module(m, k, n, bits):
    from repro_torch.roofline import kernel_costs

    assert costs.bitplane_gemv(m, k, n, bits, 2, 2) == \
        kernel_costs.bitplane_gemv(m, k, n, bits, 2, 2)


@pytest.mark.parametrize("name", CONFIGS)
def test_parameters_match_the_port(name):
    import dataclasses

    from repro_torch.config.registry import get_arch

    mod = model(name)
    cfg = dataclasses.replace(get_arch(name), **mod)
    norms = (2 * mod["n_layers"] + 1) * mod["d_model"]
    embed = mod["vocab_size"] * mod["d_model"]
    assert costs.matmul_params(mod) == cfg.param_count() - norms - embed


def test_mistral_codes_fill_the_card():
    m = model("mistral-large-123b")
    # every code once: 88 x 1,384,120,320 + 12,288 x 32,768 weights at
    # half a byte; their float32 scales 34 MB; x and y of each linear at
    # M 8 in bf16, 0.28 GB
    nbytes = costs.decode_step_bytes(m, 4, 8, 8, [])
    codes = (88 * 1_384_120_320 + 12_288 * 32_768) // 2
    assert codes == 61_102_620_672
    assert codes + 0.3e9 < nbytes < codes + 0.33e9
    # K/V: 88 layers x 2 x (8 heads x 128 + 8 bf16 scales)
    assert costs.kv_bytes_per_token(m, 8) == 88 * 2 * (1024 + 16)


def test_kernel_labels_and_routes():
    name = ("void (anonymous namespace)::dec::decode_mma_kernel<4, 16, "
            "false>(unsigned char const*, float const*)")
    assert kernel_label(name) == "dec::decode_mma_kernel<4, 16, false>"
    assert route_of(kernel_label(name)) == "decode"
    assert route_of("tc::tc_gemm_kernel<4, 8, 8, false>") == "tensor_core"
    assert route_of("tc::tc_reduce_kernel") == "tensor_core"
    assert route_of("paged_decode_split_kernel<bf16>") is None


def _event(name, lo, hi, cuda=True):
    from torch.autograd import DeviceType

    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=lo, end=hi),
        device_type=DeviceType.CUDA if cuda else DeviceType.CPU)


def test_summary_of_a_span():
    events = [_event("servebench.span", 0, 1000, cuda=False),
              _event("servebench.span", 5, 995),
              _event("servebench.step.0", 10, 380, cuda=False),
              _event("servebench.step.1", 390, 990, cuda=False),
              _event("servebench.step.1", 395, 985),
              _event("cudaGraphLaunch", 320, 600, cuda=False),
              _event("void dec::decode_mma_kernel<4>(int)", 100, 200),
              _event("void dec::decode_mma_kernel<4>(int)", 150, 300),
              _event("void tc::tc_gemm_kernel<4>(int)", 400, 500),
              _event("void tc::tc_reduce_kernel(int)", 500, 520),
              _event("void tc::tc_gemm_kernel<4>(int)", 2000, 2100)]
    s = summarize(events)
    assert s["window_s"] == pytest.approx(1e-3)
    # the union of [100, 300] and [400, 520]
    assert s["busy_s"] == pytest.approx(320e-6)
    assert s["routes"]["decode"] == {"seconds": pytest.approx(250e-6),
                                     "launches": 2}
    assert s["routes"]["tensor_core"] == {"seconds": pytest.approx(120e-6),
                                          "launches": 1}
    # by step: the decode kernels in the first window, the tile in the
    # second
    first, second = s["step_routes"]
    assert first["decode"]["launches"] == 2
    assert first["tensor_core"]["launches"] == 0
    assert second["tensor_core"] == {"seconds": pytest.approx(120e-6),
                                     "launches": 1}
    assert s["idle_gaps"][0] == ["python", pytest.approx(480e-6)]
    assert ["cudaGraphLaunch", pytest.approx(100e-6)] in s["idle_gaps"]
    assert summarize(events[1:]) == {}
