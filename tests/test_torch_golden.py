"""The port's device-numerics check (vnl_tpu_torch/check_numerics.py) on the
CPU, against the goldens vnl_tpu computed on the CPU
(vnl_tpu_torch/assets/goldens/, written by ``python
tools/export_torch_assets.py --goldens``).

(a) Each rollout golden's first 4 envs over 5 control steps through
    ``check_numerics.check_rollout`` (the kernel wrappers run their plain
    versions here), with either position stage.  Step 1 is held at the
    tolerances of tests/test_torch_rodent_env.py (observations rtol =
    atol = 1e-3, reward 1e-5, done exactly); steps 1-5 at the check's own:
    qpos within tol_t = max(5e-4, 4 spread_t), reward within 1e-2, the
    keeper's actions within 1e-2.
(b) 16 of the 128 states of each forward golden, either stage: qacc at
    the end-to-end forward tolerance rtol = atol = 5e-3
    (tests/test_pallas_cg.py:173-174).
(c) Staleness: vnl_tpu recomputes twin_actions for 3 control steps and
    forward_twin, and the first 2 envs and 4 states must equal the files
    within 1e-6, so that a change in either package shows.  Both are
    recomputed at the golden's own batch (16 envs, 128 states): XLA's CPU
    arithmetic depends on the batch size (2 envs alone end 3 steps up to
    2.9e-6 apart in qvel from the same envs in a batch of 16, 4 states
    alone 1.6e-3 apart in qacc of scale 2,000).
(d) check_numerics and chip_smoke.py import neither jax nor vnl_tpu, and
    check_numerics refuses to run on a missing CUDA device."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tools import export_torch_assets as exporter
from vnl_tpu_torch import check_numerics as cn

import torch_parity as tp

N_ENVS, N_STEPS, N_STATES = 4, 5, 16
STAGES = {"fused": True, "unfused": False}


@pytest.fixture(scope="module")
def envs():
    made = {}

    def get(scene, fused):
        if (scene, fused) not in made:
            made[scene, fused] = cn.make_env(scene, "cpu", fused)
        return made[scene, fused]
    return get


def test_goldens_layout():
    total = 0
    for name in cn.ROLLOUTS + tuple(f"forward_{s}" for s in cn.FORWARDS):
        g = cn.load_golden(name)
        total += os.path.getsize(os.path.join(cn.GOLDENS, f"{name}.npz"))
        assert "unfused" in str(g["position_stage"])
        for k, v in g.items():
            assert v.dtype.kind in "U" or v.dtype in (np.float32, np.int32), k
            assert v.dtype.kind == "U" or np.isfinite(v).all(), k
        if name.startswith("forward_"):
            assert g["qpos"].shape[0] == g["qacc"].shape[0] == 128
            continue
        steps, envs = g["qpos"].shape[:2]
        assert (steps, envs) == (21, 16) and g["spread"].shape == (21,)
        assert "actions" in g
        assert ("latent_noise" in g) == (name == "twin_keeper")
    assert total <= 2 * 2 ** 20


@pytest.mark.parametrize("name", cn.ROLLOUTS)
def test_rollout_matches_golden(envs, name, stage="unfused"):
    g = cn.load_golden(name)
    res = cn.check_rollout(name, envs(str(g["scene"]), STAGES[stage]),
                           N_ENVS, N_ENVS, N_STEPS, keep=True)
    assert res["copies"] == 1 and len(res["steps"]) == N_STEPS + 1
    first = res["trace"][1]
    np.testing.assert_allclose(first["obs"], g["obs"][1, :N_ENVS], rtol=1e-3,
                               atol=1e-3, err_msg="obs")
    np.testing.assert_allclose(first["reward"], g["reward"][1, :N_ENVS],
                               rtol=1e-5, atol=1e-5, err_msg="reward")
    np.testing.assert_array_equal(first["done"], g["done"][1, :N_ENVS])
    for t in range(1, N_STEPS + 1):
        assert res["steps"][t]["qpos"] <= res["tol_qpos"][t - 1], t
    assert res["max_reward"] <= cn.REWARD_ATOL
    if "latent_noise" in g:
        assert res["early_actions"] <= cn.ACTION_ATOL
    assert res["ok"]


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("scene", cn.FORWARDS)
def test_forward_matches_golden(envs, scene, stage):
    g = cn.load_golden(f"forward_{scene}")
    res = cn.check_forward(scene, envs(scene, STAGES[stage]), N_STATES,
                           keep=True)
    np.testing.assert_allclose(res["got"]["qacc"], g["qacc"][:N_STATES],
                               rtol=5e-3, atol=5e-3, err_msg="qacc")
    assert res["ok"] and res["states"] == N_STATES


def test_rollout_golden_is_fresh():
    got = exporter.jax_rollout("twin_actions", n_steps=3)
    g = cn.load_golden("twin_actions")
    for k, v in got.items():
        np.testing.assert_allclose(v[:, :2], g[k][:4, :2], rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(
        g["start_frame"], exporter.golden_inputs("twin_actions")
        ["start_frame"])


def test_forward_golden_is_fresh():
    qpos, qvel = exporter.forward_inputs("twin")
    g = cn.load_golden("forward_twin")
    np.testing.assert_array_equal(qpos, g["qpos"])
    np.testing.assert_array_equal(qvel, g["qvel"])
    got = exporter.jax_forward("twin", qpos, qvel)
    for k, v in got.items():
        np.testing.assert_allclose(v[:4], g[k][:4], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.fixture(scope="module")
def loaded():
    """The jax and vnl_tpu modules a fresh interpreter holds after
    importing chip_smoke, then after check_numerics has run a keeper
    rollout and an unfused forward pass on the CPU."""
    report = ("sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'vnl_tpu'))")
    code = ("import sys, json; import chip_smoke; a = " + report + "; "
            "from vnl_tpu_torch import check_numerics as cn; "
            "assert cn.check_rollout('twin_keeper', cn.make_env('twin', "
            "'cpu', True), 1, 1, 1)['ok']; "
            "assert cn.check_forward('ant', cn.make_env('ant', 'cpu', "
            "False), 2)['ok']; "
            "print(json.dumps({'chip_smoke.py': a, "
            "'vnl_tpu_torch/check_numerics.py': " + report + "}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tp.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("path", ["vnl_tpu_torch/check_numerics.py",
                                  "chip_smoke.py"])
def test_imports_neither_jax_nor_vnl_tpu(loaded, path):
    """No import statement of the file names jax or vnl_tpu, and a fresh
    interpreter that imports chip_smoke and runs parts of check_numerics
    on the CPU has loaded neither."""
    assert not _imported_roots(os.path.join(tp.ROOT, path)) & {"jax",
                                                              "vnl_tpu"}
    assert loaded[path] == []


def test_refuses_a_missing_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cn.run("cuda", 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cn.main(["--batch", "16"])


def test_expected_launches():
    assert cn.expected_launches("twin", True, 20) == {
        "position": 100, "cg": 100, "collision": 100}
    assert cn.expected_launches("humanoid", False, 0) == {
        "position": 0, "sweep": 1, "cg": 1, "collision": 1}
    assert cn.expected_launches("ant", True, 20) == {
        "position": 400, "sweep": 400, "collision": 400}
    assert cn.expected_launches("ant", False, 20) == {
        "position": 0, "sweep": 400, "collision": 400}
    need = cn.expected_launches("humanoid", False, 20)
    assert cn.launch_misses({"sweep": 20, "cg": 100, "collision": 100},
                            need) == []
    assert len(cn.launch_misses({"position": 1, "sweep": 19, "cg": 100},
                                need)) == 3
