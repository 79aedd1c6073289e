"""Dry run of one (arch x shape x mesh) cell: the JAX package's
``repro/launch/dryrun.py``.

JAX lowers and compiles the cell on 512 host devices and reads XLA's
memory and cost analyses.  The port runs one rank of the cell: its
shards as empty ``meta`` tensors on a dry production mesh
(``launch.mesh.make_production_mesh(dry=True)``: collectives that only
tally their bytes), the step run once, eagerly, under the op counter
(``roofline.op_cost``), which prices every op, every hand-written
kernel's call and every collective, and records the memory.  No device,
no memory of the cell's size, no GPU.  It prints the memory and cost
figures, derives the three roofline terms on the H100's data-sheet rates
(``roofline.analysis.HW_H100``) and writes the record, JAX's fields with
``count_s`` (the seconds the count took) in place of ``lower_s`` /
``compile_s``, to ``<out>/<arch>__<shape>__<pod|multipod>[...].json``.

``--engine-backend`` and ``--attn-backend`` default to ``auto``,
resolved as on the card (``cuda``): the dry run prices the program the
card runs.  ``reference`` / ``gather`` stay selectable.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
      --shape decode_32k --paged --engine-bits 4 --kv-bits 8 \\
      [--multi-pod] [--out build/dryrun]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict


def _resolved(name: str) -> str:
    return "cuda" if name in ("auto", "", None) else name


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             engine_bits: int = 0, engine_radix: int = 1, kv_bits: int = 0,
             engine_backend: str = "auto",
             attn_backend: str = "auto",
             engine_sharded: bool = False, psum_bits: int = 0,
             split_local: bool = False, paged: bool = False,
             chunked_prefill: bool = False,
             remat: str = "block",
             microbatches: int = 1, grad_compress_bits: int = 0,
             out_dir: str = "build/dryrun", tag: str = "") -> Dict[str, Any]:
    """Count one rank of the cell and write its record (module docstring);
    returns the record."""
    from repro_torch.config import SHAPES, get_arch
    from repro_torch.config.base import (EngineConfig, MeshConfig,
                                         RunConfig, ServeConfig,
                                         TrainConfig)
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_cell, cache_bytes
    from repro_torch.roofline.analysis import (counted_costs,
                                               model_bytes_for_cell,
                                               model_flops_for_cell,
                                               roofline_report)

    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        raise SystemExit(
            f"{arch} is pure full-attention: long_500k is skipped by design "
            "(see DESIGN.md §Arch-applicability)")

    eng = EngineConfig(weight_bits=engine_bits, radix=engine_radix,
                       kv_bits=kv_bits, backend=_resolved(engine_backend),
                       attn_backend=_resolved(attn_backend),
                       sharded=engine_sharded, psum_bits=psum_bits)
    run = RunConfig(
        model=cfg,
        shape=shape,
        mesh=MeshConfig(multi_pod=multi_pod),
        train=TrainConfig(remat=remat, microbatches=microbatches,
                          grad_compress_bits=grad_compress_bits),
        serve=ServeConfig(engine=eng),
    )

    mesh = make_production_mesh(multi_pod=multi_pod, dry=True)
    n_dev = mesh.size
    kw = ({"split_local": split_local, "paged": paged}
          if shape.kind == "decode"
          else {"chunked": chunked_prefill}
          if shape.kind == "prefill" else {})

    fn, args, kind = build_cell(run, mesh, abstract=True, **dict(kw))
    counted = counted_costs(fn, *args)
    del fn, args

    print(f"=== {arch} x {shape_name} on {dict(mesh.shape)} ({kind}), "
          f"rank {mesh.rank} ===")
    print(counted["memory_analysis"])
    print({"flops": counted["flops"], "bytes accessed": counted["bytes"],
           "transcendentals": counted["transcendentals"]})
    print({"priced": counted["priced"]})

    report = roofline_report(
        counted, n_dev,
        model_flops=model_flops_for_cell(cfg, shape),
        model_bytes=model_bytes_for_cell(
            cfg, shape, engine_bits,
            cache_bytes(run, kind, paged=paged, chunked=chunked_prefill,
                        split_local=split_local)))
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": list(mesh.shape.values()),
        "multi_pod": multi_pod,
        "kind": kind,
        "engine_bits": engine_bits,
        "engine_radix": engine_radix,
        "kv_bits": kv_bits,
        "engine_backend": (_resolved(engine_backend)
                           if (engine_bits or kv_bits) else ""),
        "attn_backend": _resolved(attn_backend) if paged else "",
        "engine_sharded": engine_sharded,
        "psum_bits": psum_bits,
        "split_local": split_local,
        "paged": paged,
        "chunked_prefill": chunked_prefill,
        "remat": remat,
        "microbatches": microbatches,
        "grad_compress_bits": grad_compress_bits,
        "tag": tag,
        "count_s": round(counted["count_s"], 2),
        "priced": counted["priced"],
        **report,
    }

    os.makedirs(out_dir, exist_ok=True)
    suffix = "multipod" if multi_pod else "pod"
    name = f"{arch}__{shape_name}__{suffix}"
    if engine_bits:
        name += f"__eng{engine_bits}r{engine_radix}"
    if engine_sharded:
        name += "__sharded"
        if psum_bits:
            name += f"p{psum_bits}"
    if kv_bits:
        name += f"__kv{kv_bits}"
    if split_local:
        name += "__splitlocal"
    if paged:
        name += "__paged"
        if attn_backend != "auto":
            name += f"__attn-{attn_backend}"
    if chunked_prefill:
        name += "__chunked"
    if tag:
        name += f"__{tag}"
    path = os.path.join(out_dir, name + ".json")
    with open(path, "w") as f:
        json.dump(record, f, indent=2, default=float)
    print(f"terms: compute={report['compute_s']:.4e}s "
          f"memory={report['memory_s']:.4e}s "
          f"collective={report['collective_s']:.4e}s "
          f"dominant={report['dominant']} "
          f"roofline_fraction={report.get('roofline_fraction', 0):.3f}")
    print(f"wrote {path}")
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=[
        "train_4k", "prefill_32k", "decode_32k", "long_500k"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--engine-bits", type=int, default=0)
    ap.add_argument("--engine-radix", type=int, default=1)
    ap.add_argument("--kv-bits", type=int, default=0,
                    help="int8 bit-planed KV cache/pages (0 = off)")
    ap.add_argument("--engine-backend", default="auto",
                    help="engine backend registry name (auto = cuda, as "
                         "on the card; reference | bit_serial)")
    ap.add_argument("--attn-backend", default="auto",
                    help="attention read path: auto (= cuda, as on the "
                         "card) | gather")
    ap.add_argument("--engine-sharded", action="store_true",
                    help="wrap the backend in the mesh's 'sharded' "
                         "dispatch (on by itself past one model rank)")
    ap.add_argument("--psum-bits", type=int, default=0,
                    help="row-parallel partial-GEMV reduction: 0 = fp32 "
                         "psum, 4/8 = compressed codes")
    ap.add_argument("--split-local", action="store_true")
    ap.add_argument("--paged", action="store_true",
                    help="count the paged-KV block-table decode cell")
    ap.add_argument("--chunked-prefill", action="store_true",
                    help="count the scheduler's per-step chunked-prefill "
                         "cell (paged pool + per-lane pos0/seq_lens) "
                         "instead of one-shot prefill")
    ap.add_argument("--remat", default="block")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress-bits", type=int, default=0)
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
             engine_bits=args.engine_bits, engine_radix=args.engine_radix,
             kv_bits=args.kv_bits, engine_backend=args.engine_backend,
             attn_backend=args.attn_backend,
             engine_sharded=args.engine_sharded, psum_bits=args.psum_bits,
             split_local=args.split_local, paged=args.paged,
             chunked_prefill=args.chunked_prefill,
             remat=args.remat,
             microbatches=args.microbatches,
             grad_compress_bits=args.grad_compress_bits,
             out_dir=args.out, tag=args.tag)


if __name__ == "__main__":
    main()
