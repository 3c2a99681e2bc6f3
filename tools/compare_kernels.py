"""Times kernels A, B and C of two trees of the port on one CUDA device, in
turns (old, new, new, old), at the shapes the rollouts give them (1024
envs: the rodent twin's A, B and C, C on the (2, 1024, 73, 73) stack
[qM, qM + h diag(B)]; the humanoid's A and B, its contact states pressed
0.3 into the floor, and C on its (2, 1024, 27, 27) stack; the ant's A
and C on the 1024 Hessians of its first Newton iteration), and prints one
JSON line with every turn and the median of each tree's turns.  Each turn
also hashes kernel A's outputs at the three scenes' inputs
(``position_digest``); ``position_same_bits`` says whether every turn of
both trees gave the same bits.

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
import hashlib
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 1024
SCENES = ("humanoid", "ant")   # kernel_bench.scene: A (and B) at their shapes
KEYS = ("position_ms", "cg_ms", "sweep_ms", "position_humanoid_ms",
        "cg_humanoid_ms", "sweep_humanoid_ms", "position_ant_ms",
        "sweep_ant_ms")


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

    def ms(fn):
        return kb.time_ms(fn, reps=50, queued=kb.QUEUED)

    digest = hashlib.sha256()

    def bits(outs):
        for o in outs:
            digest.update(o.cpu().numpy().tobytes())

    bits(pos._launch(m, qpos))
    out = dict(root=os.path.relpath(root, ROOT),
               position_ms=ms(lambda: pos._launch(m, qpos)),
               cg_ms=ms(lambda: cg_ops._launch(st, args)),
               sweep_ms=ms(lambda: sweep._launch(pair)))
    for name in SCENES:
        sm, kw = kb.scene(name)
        gen = torch.Generator(device="cuda").manual_seed(0)
        q = kb.random_states(sm, BATCH, gen)
        bits(pos._launch(sm, q))
        out[f"position_{name}_ms"] = ms(lambda: pos._launch(sm, q))
        if "cg" in kw["kernels"]:
            (a, s), _ = kb.contact_states(sm, BATCH, gen, kw["press"])
            out[f"cg_{name}_ms"] = ms(lambda: cg_ops._launch(s, a))
            c = kb.twin_pair(sm, q)           # the unfused stage's pair
        else:                                 # the Newton Hessians
            c, _ = kb.newton_hessians(sm, BATCH, gen, kw["press"])
        out[f"sweep_{name}_ms"] = ms(lambda: sweep._launch(c))
    out["position_digest"] = digest.hexdigest()
    return out


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

    same = len({t["position_digest"] for t in turns}) == 1
    print(json.dumps(dict(card=smi, batch=BATCH, turns=turns,
                          position_same_bits=same, **{
        k: dict(old=med("old", k), new=med("new", k)) for k in KEYS})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
