"""Multi-pod dry run: trace every (arch x shape x mesh) cell on a fake
process group.

Port of `repro.launch.dryrun`. Where the reference forces 512 host
devices, lowers and compiles each cell's step and reads XLA's memory and
cost analyses, the port starts the "fake" process group
(`torch.testing._internal.distributed.fake_pg`) at world size 512, builds
the production mesh and a `Sharder` over it, makes params, optimizer
state, batch and caches as DTensors of fake local shards
(`FakeTensorMode`: nothing is allocated, on the card or off it), and runs
the cell's train, prefill or decode step once under
`roofline.counter.StepCounter`. Every collective goes to the fake group,
which moves nothing; a hand-written kernel's wrapper takes its fake
branch (no build, no launch; its `fake_calls` count). Numbers are rank
0's. Reports stream to reports/dryrun_torch/*.json.

Report keys, in torch terms:

* ``argument_size_in_bytes``: the local bytes of everything the step
  takes (params, optimizer state, batch, caches).
* ``output_size_in_bytes``: the local bytes of what it returns.
* ``alias_size_in_bytes``: the arguments the reference donates: params
  and optimizer state for train, the caches for decode (the port updates
  them in place), 0 for prefill.
* ``temp_size_in_bytes``: the counter's peak of live bytes above the
  arguments and the step's new outputs (XLA's temp excludes both), so
  that ``hbm_per_device_bytes``, by the reference's formula
  ``args + temp + max(out - alias, 0)``, is the traced peak.
* ``parsed_flops_per_device``, ``parsed_hbm_bytes_per_device``,
  ``collective_bytes_by_op``, ``collective_bytes_per_device``: the
  counter's ``dot_flops``, ``hbm_bytes``, ``coll_by_op``, ``coll_bytes``
  (a kernel's products and bytes by its wrapper's own count).
  ``hlo_flops_per_device`` and ``hlo_bytes_per_device`` equal them: an
  eager trace runs every loop trip, so there is no count-once number.
* ``lower_s``: building the abstract state; ``compile_s``: the traced
  step's wall (the port compiles nothing).
* ``roofline``: `roofline.analysis.roofline_terms` with the H100's
  constants over ``chips`` (256 or 512), with ``model_flops`` and
  ``useful_flops_ratio``.
* ``kernels``: per hand-written kernel the calls, flop and bytes counted.
* ``hlo_text_bytes``: the length of the counter's per-op log (op, local
  shapes, flop, bytes), which ``save_hlo`` writes in place of HLO text.

Left out, having no torch meaning: ``memory_analysis_str``,
``generated_code_size_in_bytes``, ``cost_analysis_keys``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape train_4k [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod both]

`--device` (default: the card, which must be visible) sets the fake
tensors' device and so the route: on "cuda" the model takes the card's
kernels (their fake branches), on "cpu" their plain versions.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import (ARCHS, SHAPES_BY_NAME, get_model,
                                 get_run_config)
from repro_torch.configs.shapes import shape_applicable
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import Sharder, contiguous_strides
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.params import TensorSpec, tree_map
from repro_torch.roofline import analysis as RA
from repro_torch.roofline.counter import StepCounter
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.step import (build_decode_step, build_prefill_step,
                                    build_train_step)

REPORT_DIR = Path(__file__).resolve().parents[3] / "reports" / "dryrun_torch"
WORLD = 512          # the reference's forced host device count

# the reference's cache axes (`src/repro/launch/dryrun.py:40-48`)
CACHE_AXES = {
    "cache_len": ("batch",),
    "k": (None, None, "batch", "kvseq", "kv_heads", None),
    "v": (None, None, "batch", "kvseq", "kv_heads", None),
    "ssm_h": (None, None, "batch", "heads", None, None),
    "ssm_conv": (None, None, "batch", None, "ssm"),
    "cross_k": (None, None, "batch", None, "kv_heads", None),
    "cross_v": (None, None, "batch", None, "kv_heads", None),
}


def abstract_cache_specs(cfg, B, S, sharder: Sharder):
    shapes = M.cache_shapes(cfg, B, S)
    return {k: TensorSpec(v.shape, v.dtype,
                          sharder.act_sharding(CACHE_AXES[k], v.shape))
            for k, v in shapes.items()}


def abstract_args(run, shape, sharder: Sharder):
    """The step's arguments as TensorSpec trees with their shardings:
    {"params", "batch"} and "opt_state" (train) or "caches" (decode), and
    the train step's OptConfig (None otherwise)."""
    cfg = run.model
    args = {"params": M.abstract_params(cfg, sharder.param_sharding,
                                        quantize=run.quantize_weights),
            "batch": M.input_specs(cfg, shape, sharder.act_sharding)}
    opt_cfg = None
    if shape.kind == "train":
        opt_cfg = opt_mod.OptConfig(name=run.optimizer,
                                    bf16_moments=run.bf16_moments)
        args["opt_state"] = opt_mod.abstract_state(
            M.param_specs(cfg), opt_cfg, sharder.param_sharding)
    elif shape.kind == "decode":
        args["caches"] = abstract_cache_specs(cfg, shape.global_batch,
                                              shape.seq_len, sharder)
    return args, opt_cfg


def local_shape(spec: TensorSpec, mesh_shape):
    """Rank 0's shard of `spec`: each dim ceil-divided by the sizes of the
    mesh dims that shard it (`spec.sharding`: DTensor placements, one per
    mesh dim; None is replicated)."""
    from torch.distributed.tensor import Shard

    shape = list(spec.shape)
    for m, pl in enumerate(spec.sharding or ()):
        if isinstance(pl, Shard):
            d = pl.dim % len(shape)
            shape[d] = math.ceil(shape[d] / int(mesh_shape[m]))
    return tuple(shape)


def local_bytes(tree, mesh_shape=None) -> int:
    """Rank 0's bytes of a tree of TensorSpecs (with `mesh_shape`), or of
    tensors and DTensors (local shards)."""
    from torch.distributed.tensor import DTensor

    def leaves(t):
        if isinstance(t, dict):
            return [x for v in t.values() for x in leaves(v)]
        if isinstance(t, (list, tuple)) and not isinstance(t, TensorSpec):
            return [x for v in t for x in leaves(v)]
        return [t]

    total = 0
    for leaf in leaves(tree):
        if isinstance(leaf, TensorSpec):
            n = math.prod(local_shape(leaf, mesh_shape))
            total += n * leaf.dtype.itemsize
        elif isinstance(leaf, torch.Tensor):
            t = leaf.to_local() if isinstance(leaf, DTensor) else leaf
            total += t.numel() * t.element_size()
    return total


@contextlib.contextmanager
def fake_world(world: int = WORLD):
    """The default process group: the one already started, else a "fake"
    group of `world` ranks (rank 0), destroyed on the way out."""
    import torch.distributed as dist

    if dist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _dtensor(spec: TensorSpec, mesh, device):
    """A DTensor of `spec` whose local shard is an empty tensor on `device`
    (fake under `FakeTensorMode`)."""
    from torch.distributed.tensor import DTensor, Replicate

    placements = spec.sharding or (Replicate(),) * mesh.ndim
    local = torch.empty(local_shape(spec._replace(sharding=placements),
                                    tuple(mesh.shape)),
                        dtype=spec.dtype, device=device)
    return DTensor.from_local(
        local, mesh, placements, run_check=False, shape=spec.shape,
        stride=contiguous_strides(spec.shape))


class _Log(io.StringIO):
    """The counter's per-op log: its length always, its text when kept."""

    def __init__(self, keep: bool):
        super().__init__()
        self.keep, self.n = keep, 0

    def write(self, s):
        self.n += len(s)
        return super().write(s) if self.keep else len(s)


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               run_override=None, tag: str = "", save_hlo: str = "",
               device=None):
    """Trace one cell's step on the fake group; return the report dict.
    The shape is `run.shape` (the named shape for every run of
    `get_run_config`; an override may cut it)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    run = run_override or get_run_config(arch, shape_name)
    cfg, shape = run.model, run.shape
    dev = resolve_device(device)
    with fake_world():
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type=dev.type)
        chips = math.prod(int(s) for s in mesh.shape)
        sharder = Sharder(mesh, run)

        t0 = time.time()
        specs, opt_cfg = abstract_args(run, shape, sharder)
        log = _Log(bool(save_hlo))
        with FakeTensorMode():
            args = tree_map(lambda s: _dtensor(s, mesh, dev), specs)
            t_lower = time.time() - t0
            with StepCounter(log=log) as counter:
                args_b = counter.track(args)
                if shape.kind == "train":
                    step = build_train_step(cfg, run, opt_cfg,
                                            sharder.constrain)
                    out = step(args["params"], args["opt_state"],
                               args["batch"])
                    donated = (args["params"], args["opt_state"])
                else:
                    with torch.no_grad():
                        if shape.kind == "prefill":
                            step = build_prefill_step(
                                cfg, run, shape.seq_len, sharder.constrain)
                            out = step(args["params"], args["batch"])
                            donated = ()
                        else:
                            step = build_decode_step(cfg, run,
                                                     sharder.constrain)
                            out = step(args["params"], args["caches"],
                                       args["batch"])
                            donated = (args["caches"],)
                t_compile = time.time() - t0 - t_lower
                peak = counter.peak
            out_b = local_bytes(out)
            alias_b = local_bytes(donated)
            del out, args
    parsed = counter.totals()
    if save_hlo:
        Path(save_hlo).write_text(log.getvalue())

    report = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips,
        "kind": shape.kind, "lower_s": round(t_lower, 1),
        "compile_s": round(t_compile, 1), "tag": tag, "device": dev.type,
    }
    # ---- memory (rank 0) ----
    new_out = max(out_b - alias_b, 0)
    report["argument_size_in_bytes"] = int(args_b)
    report["output_size_in_bytes"] = int(out_b)
    report["temp_size_in_bytes"] = int(max(peak - args_b - new_out, 0))
    report["alias_size_in_bytes"] = int(alias_b)
    report["hbm_per_device_bytes"] = (args_b + report["temp_size_in_bytes"]
                                      + new_out)
    # ---- the counter (every trip counted, so no count-once numbers) ----
    report["hlo_flops_per_device"] = parsed["dot_flops"]
    report["hlo_bytes_per_device"] = parsed["hbm_bytes"]
    report["hlo_text_bytes"] = log.n
    report["parsed_flops_per_device"] = parsed["dot_flops"]
    report["parsed_hbm_bytes_per_device"] = parsed["hbm_bytes"]
    report["collective_bytes_by_op"] = parsed["coll_by_op"]
    report["collective_bytes_per_device"] = parsed["coll_bytes"]
    report["kernels"] = parsed["kernels"]
    # ---- roofline terms ----
    flops_total = report["parsed_flops_per_device"] * chips
    hbm_total = report["parsed_hbm_bytes_per_device"] * chips
    coll_total = report["collective_bytes_per_device"] * chips
    terms = RA.roofline_terms(flops_total, hbm_total, coll_total, chips)
    mf = RA.model_flops(cfg, shape)
    terms["model_flops"] = mf
    terms["useful_flops_ratio"] = mf / flops_total if flops_total else 0.0
    report["roofline"] = terms
    return report


def run_cell(arch, shape_name, multi_pod, out_dir: Path, tag="",
             device=None):
    mesh_tag = "pod2" if multi_pod else "pod1"
    name = f"{arch}__{shape_name}__{mesh_tag}{('__' + tag) if tag else ''}"
    out = out_dir / f"{name}.json"
    try:
        rep = lower_cell(arch, shape_name, multi_pod, tag=tag, device=device)
        status = "ok"
    except Exception as e:
        rep = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
               "error": repr(e), "traceback": traceback.format_exc()}
        status = "FAIL"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rep, indent=2, default=str))
    r = rep.get("roofline", {})
    print(f"[{status}] {name} compile={rep.get('compile_s', '-')}s "
          f"dom={r.get('dominant', '-')} "
          f"frac={r.get('roofline_fraction', 0):.3f}", flush=True)
    return status == "ok"


def cells(args):
    """(arch, shape, applicable) for the flags, in the reference's order."""
    if args.all:
        return [(arch, sname, shape_applicable(cfg, s))
                for arch, cfg in ARCHS.items()
                for sname, s in SHAPES_BY_NAME.items()]
    assert args.arch and args.shape, "--arch/--shape or --all"
    return [(args.arch, args.shape,
             shape_applicable(get_model(args.arch),
                              SHAPES_BY_NAME[args.shape]))]


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["off", "on", "both"],
                    default="off")
    ap.add_argument("--out", default=str(REPORT_DIR))
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device of the fake tensors (default: the "
                         "card, 'cuda'; 'cpu' takes the plain versions)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    out_dir = Path(args.out)
    pods = {"off": [False], "on": [True], "both": [False, True]}[
        args.multi_pod]

    n_ok = n_skip = n_fail = 0
    for arch, sname, applicable in cells(args):
        if not applicable:
            print(f"[SKIP] {arch}__{sname} (long_500k needs sub-quadratic "
                  "attention; see DESIGN.md §4)", flush=True)
            n_skip += 1
            continue
        for mp in pods:
            mesh_tag = "pod2" if mp else "pod1"
            if args.skip_existing and (
                    out_dir / f"{arch}__{sname}__{mesh_tag}.json").exists():
                continue
            ok = run_cell(arch, sname, mp, out_dir, device=args.device)
            n_ok += ok
            n_fail += (not ok)
    print(f"done: ok={n_ok} fail={n_fail} skipped_cells={n_skip}")


if __name__ == "__main__":
    main()
