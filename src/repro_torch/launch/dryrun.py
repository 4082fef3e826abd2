"""Multi-pod dry run (port of ``repro.launch.dryrun``).

For every (architecture x input-shape x mesh) cell: build the production
mesh over a ``fake`` process group of 256 (16x16) or 512 (2x16x16)
ranks, place the parameters, the optimizer state and the batch on it as
DTensors whose shards are meta tensors (nothing is allocated), run the
step once as rank 0 under ``activation_sharding`` and
``distributed.op_analysis.OpCounter``, and record its cost per device
and memory into a JSON line.  Nothing computes on any device: the meta
tensors are the counterpart of the reference's ``ShapeDtypeStruct``s on
forced host devices, and the fake group's collectives are shape
functions.  A failure here (a placement DTensor cannot follow, a shape
that does not divide) is a bug in the system.

Where the reference lowers and compiles the step and walks its HLO
(``hlo_analysis``), the port runs it eagerly and counts the ops one rank
dispatches (``op_analysis``): every layer and microbatch runs, so the
counts need no trip-count recovery.  ``lower_s`` is that run's time.
The record keeps the reference's keys where the quantity exists; the
XLA-only ones (``compile_s``, ``xla_flops_per_dev``,
``xla_bytes_per_dev``, ``generated_code_bytes``, ``alias_bytes``) have no
counterpart and are left out.  ``hlo_*`` keys keep their names (the
op counter's numbers).  ``memory``: ``argument_bytes`` the local shards
of the step's arguments on rank 0, ``output_bytes`` those of its
results, ``temp_bytes`` the peak of the storages the step creates (on
top of the arguments).  A decode cell's ``cache_index`` is a host int
(the last position), as the port's scalar write position is one.

Usage (``--mesh pod``, the 16x16 mesh, by default):
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both --out dry.jsonl
  python -m repro_torch.launch.dryrun --arch mamba2-130m --optimized

``--optimized`` lowers each arch's training deployment
(``get_config(arch, optimized=True)``: the "fsdp" rules); each record
names its rule profile (``profile``).
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import time
import traceback
from typing import Any, Dict, Optional, Union

import torch

from repro_torch import convert
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.tech import H100
from repro_torch.distributed import context as dist_context
from repro_torch.distributed import op_analysis, sharding
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import SHAPES, InputShape, model, shape_applicable
from repro_torch.models.spec import abstract, leaves
from repro_torch.optim import adamw
from repro_torch.runtime import steps

# The reference declares the SSD state bf16 (the port holds it f32; see
# ``models.ssm``): the analytic floor counts it as the reference does.
_DECLARED_ITEMSIZE = {"ssd/state": 2}


def analytic_bytes_per_dev(cfg, shape, n_dev: int, tp: int = 16,
                           dp: Optional[int] = None) -> float:
    """The reference's coarse analytic HBM-traffic floor per device:
    weight/grad/optimizer/activation/cache passes for an ideally fused
    program (a copy of ``repro.launch.dryrun.analytic_bytes_per_dev``,
    cache bytes from ``cache_specs`` at the reference's dtypes)."""
    Na = cfg.n_active_params()
    dp = dp or (n_dev // tp)
    B, S = shape.global_batch, shape.seq_len
    b_loc = max(B // dp, 1)
    d = cfg.d_model
    L = cfg.n_layers
    if shape.kind == "train":
        w = 3 * 2 * Na / tp                      # gather-write + fwd/bwd reads
        g = 2 * 4 * Na / tp * max(cfg.microbatch, 1)   # f32 grad accum r/w
        opt = 6 * 4 * Na / n_dev                 # m, v, master r+w
        acts = L * b_loc * S * d * 2 * 4 * 2     # saved residuals w+r
        logits = 2 * b_loc * S * (cfg.padded_vocab / tp) * 4
        return w + g + opt + acts + logits
    cache = 0.0
    if shape.kind in ("prefill", "decode"):
        total = 0
        for path, a in leaves(abstract(model.cache_specs(cfg, B, S))):
            size = next((v for k, v in _DECLARED_ITEMSIZE.items()
                         if path.endswith(k)), a.element_size())
            total += a.numel() * size
        cache = total / n_dev
    if shape.kind == "prefill":
        w = 2 * 2 * Na / tp
        acts = L * b_loc * S * d * 2 * 2
        return w + acts + 2 * cache
    # decode: every parameter read once per step + cache read + write slice.
    w = 2 * Na / tp
    return w + cache


def cell_arithmetic(cfg, shape, n_dev: int, tp: int = 16) -> Dict[str, Any]:
    """A cell's fields that need no run, the reference's formulas:
    ``params``, ``active_params``, ``tokens`` (a decode step's: one a
    row), ``model_flops_global`` (6 N T to train, 2 N T to serve, N the
    active parameters) and the analytic floor.  ``tp``: the mesh's model
    axis (the reference's 16 on its meshes)."""
    na = cfg.n_active_params()
    if shape.kind in ("train", "prefill"):
        tokens = shape.global_batch * shape.seq_len
    else:
        tokens = shape.global_batch
    ana = analytic_bytes_per_dev(cfg, shape, n_dev, tp=tp)
    return {"analytic_bytes_per_dev": ana,
            "memory_s_analytic": ana / H100.hbm_bw,
            "params": cfg.n_params(), "active_params": na, "tokens": tokens,
            "model_flops_global": (6.0 if shape.kind == "train" else 2.0)
            * na * tokens}


def argument_bytes(args) -> int:
    """Bytes of this rank's shards of every tensor in ``args`` (a tuple
    of a step's arguments or results: ``CausalLM``s, nested dicts,
    tensors)."""
    total = 0
    for a in args:
        tree = model.param_tree(a) if isinstance(a, model.CausalLM) else a
        for _, t in leaves(tree):
            if isinstance(t, torch.Tensor):
                t = t.to_local() if dist_context.is_dtensor(t) else t
                total += t.numel() * t.element_size()
    return total


def abstract_model(cfg, mesh, rules, trainable: bool) -> model.CausalLM:
    """The parameters as DTensors on ``mesh`` whose shards are meta
    tensors, placed by ``rules``."""
    return convert.shard_params(
        model.CausalLM(cfg, model.abstract_params(cfg), trainable=trainable),
        mesh, rules)


def step_arguments(cfg, shape: InputShape, mesh, rules):
    """(step, its arguments) for one cell, every array a DTensor of meta
    shards: the parameters, AdamW's state for a train step, and the batch
    placed as the step places it."""
    lm = abstract_model(cfg, mesh, rules, trainable=shape.kind == "train")
    batch = model.input_specs(cfg, shape)
    step = steps.make_step(cfg, shape.kind, adamw.OptConfig())
    if shape.kind == "decode":
        batch["cache_index"] = shape.seq_len - 1
    if shape.kind == "train":
        placed = steps._place_batch(batch, mesh, None)
        return step, (lm, adamw.init(lm), placed)
    return step, (lm, steps._place_serving(cfg, lm, batch))


def mesh_name(mesh) -> str:
    return "x".join(str(int(n)) for n in mesh.shape)


def lower_cell(arch: str, shape: Union[str, InputShape],
               multi_pod: bool = False, cfg=None,
               mesh=None) -> Dict[str, Any]:
    """One cell's record.  ``shape``: a name of ``SHAPES`` or an
    ``InputShape`` (a cell at another size); ``mesh``: a named
    ``DeviceMesh`` (default: the production mesh, over an initialised
    group of 256 or 512 ranks, a ``fake`` one for the sweep)."""
    t0 = time.time()
    cfg = cfg or get_config(arch)
    if isinstance(shape, str):
        shape = SHAPES[shape]
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape.name,
        "mesh": (mesh_name(mesh) if mesh is not None
                 else "2x16x16" if multi_pod else "16x16"),
        "kind": shape.kind,
    }
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec
    try:
        if mesh is None:
            mesh = make_production_mesh(multi_pod=multi_pod)
        rules = sharding.RULE_PROFILES[cfg.sharding_profile]
        step, args = step_arguments(cfg, shape, mesh, rules)
        arg_bytes = argument_bytes(args)
        with dist_context.activation_sharding(mesh, rules), \
                op_analysis.OpCounter() as counter:
            out = step(*args)
        t_lower = time.time()
        out_bytes = argument_bytes(out)
        cost = counter.cost
        roof = op_analysis.roofline_from_cost(cost)

        n_dev = math.prod(int(s) for s in mesh.shape)
        arith = cell_arithmetic(cfg, shape, n_dev,
                                sharding.axis_sizes(mesh).get("model", 1))
        model_flops = arith["model_flops_global"]
        rec.update(arith)
        rec.update({
            "status": "ok",
            "n_devices": int(n_dev),
            "lower_s": round(t_lower - t0, 2),
            "hlo_flops_per_dev": roof.flops,
            "hlo_bytes_per_dev": roof.hbm_bytes,
            "hlo_bytes_strict_per_dev": cost.bytes_strict,
            "collective_bytes_per_dev": roof.collective_bytes,
            "compute_s": roof.compute_s,
            "memory_s": roof.memory_s,
            "collective_s": roof.collective_s,
            "dominant": roof.dominant,
            "useful_flops_ratio": (model_flops / n_dev) / roof.flops
            if roof.flops else None,
            "collectives": roof.collectives,
            "collective_counts": roof.collective_counts,
            "ops": cost.n_ops,
            "memory": {"argument_bytes": arg_bytes,
                       "output_bytes": out_bytes,
                       "temp_bytes": cost.peak_bytes},
        })
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def fake_group(world_size: int) -> None:
    """Join a ``fake`` process group of ``world_size`` ranks as rank 0
    (no devices, no collectives), replacing any group this process has;
    ``torch.distributed.destroy_process_group()`` leaves it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS), default=None)
    ap.add_argument("--shape", choices=list(SHAPES), default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="each arch's training deployment "
                         "(get_config(arch, optimized=True): the fsdp "
                         "profile)")
    ap.add_argument("--out", default=None,
                    help="append JSONL records to this file")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"pod": [False], "multipod": [True], "both": [False, True]}[
        args.mesh]

    out_path = pathlib.Path(args.out) if args.out else None
    if out_path:
        out_path.parent.mkdir(parents=True, exist_ok=True)

    import warnings
    warnings.filterwarnings("ignore", module="torch.distributed")
    try:
        for multi_pod in meshes:
            fake_group(512 if multi_pod else 256)
            mesh = make_production_mesh(multi_pod=multi_pod)
            for arch in archs:
                cfg = get_config(arch, optimized=args.optimized)
                for shape_name in shapes:
                    rec = lower_cell(arch, shape_name, multi_pod, cfg=cfg,
                                     mesh=mesh)
                    rec["mesh"] = "2x16x16" if multi_pod else "16x16"
                    rec["profile"] = cfg.sharding_profile
                    summary = {k: rec.get(k) for k in
                               ("arch", "shape", "mesh", "status",
                                "dominant", "lower_s", "error")}
                    print(json.dumps(summary), flush=True)
                    if out_path:
                        with out_path.open("a") as f:
                            f.write(json.dumps(rec) + "\n")
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
