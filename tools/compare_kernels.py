"""Times kernels A, B and C of two trees of the port on one CUDA device, in
turns (old, new, new, old), at the shapes the rollout gives them (the
rodent twin, 1024 envs; for C the (2, 1024, 73, 73) stack
[qM, qM + h diag(B)]), and prints one JSON line with every turn and the
median of each tree's turns.

Each turn is a process of its own that imports ``vnl_tpu_torch`` from one
tree, builds that tree's kernels and times ``ops.position._launch``,
``ops.cg._launch`` and ``ops.sweep._launch`` on inputs made from the same
seed.  ``--old`` names a directory that holds an earlier ``vnl_tpu_torch``
and ``chip_smoke.py`` (for example
``git archive <commit> | tar -x -C build/parent``).

  python3 tools/compare_kernels.py --old build/parent
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 1024


def time_tree(root: str) -> dict:
    """Imports the port from ``root``; inputs and timer are this tree's
    kernel_bench (loaded by path, it imports the port only inside its
    functions), so both trees are measured alike."""
    import importlib.util
    sys.path.insert(0, root)
    import torch
    spec = importlib.util.spec_from_file_location(
        "kernel_bench_of_this_tree",
        os.path.join(ROOT, "vnl_tpu_torch", "kernel_bench.py"))
    kb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kb)
    from vnl_tpu_torch import compat
    from vnl_tpu_torch.ops import cg as cg_ops
    from vnl_tpu_torch.ops import position as pos
    from vnl_tpu_torch.ops import sweep
    from vnl_tpu_torch.physics import forward
    forward.pin_fp32()
    m = compat.model_from_numpy(compat.TWIN_MODEL, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    qpos = kb.random_states(m, BATCH, gen)
    (args, st), _ = kb.contact_states(m, BATCH, gen)
    pair = kb.twin_pair(m, qpos)
    return dict(root=os.path.relpath(root, ROOT),
               position_ms=kb.time_ms(lambda: pos._launch(m, qpos), reps=50,
                                      queued=kb.QUEUED),
               cg_ms=kb.time_ms(lambda: cg_ops._launch(st, args), reps=50,
                                queued=kb.QUEUED),
               sweep_ms=kb.time_ms(lambda: sweep._launch(pair), reps=50,
                                   queued=kb.QUEUED))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--old", help="directory of the earlier tree")
    p.add_argument("--time-root", help="(internal) time this tree and exit")
    args = p.parse_args()
    if args.time_root:
        print(json.dumps(time_tree(os.path.abspath(args.time_root))))
        return 0
    if not args.old:
        p.error("--old is required")
    turns = []
    old = os.path.abspath(args.old)
    for name, root in (("old", old), ("new", ROOT), ("new", ROOT),
                       ("old", old)):
        env = dict(os.environ, VNL_TPU_TORCH_BUILD=os.path.join(
            root, "build", "kernels"))
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--time-root", root],
            cwd=root, env=env, capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        turns.append(dict(json.loads(out.stdout.strip().splitlines()[-1]),
                          tree=name))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()

    def med(tree, key):
        return statistics.median(t[key] for t in turns if t["tree"] == tree)

    print(json.dumps(dict(card=smi, batch=BATCH, turns=turns, **{
        k: dict(old=med("old", k), new=med("new", k))
        for k in ("position_ms", "cg_ms", "sweep_ms")})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
