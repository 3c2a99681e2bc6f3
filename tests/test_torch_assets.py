"""The port's numpy assets: the committed rodent twin compiles, in vnl_tpu,
to exactly the committed model npz; its widths are the rodent's; the
keeper's policy weights round-trip through the torch converter."""

import numpy as np
import pytest
import yaml

from tools import export_torch_assets as exporter
from vnl_tpu_torch import compat
from vnl_tpu_torch.envs.rodent import RODENT_NAMES

import torch_parity as tp


def test_model_npz_equals_fresh_compile():
    fresh = exporter.model_to_numpy(tp.jax_twin())
    with np.load(compat.TWIN_MODEL) as z:
        committed = {k: z[k] for k in z.files}
    assert sorted(fresh) == sorted(committed)
    for k, v in fresh.items():
        assert v.dtype == committed[k].dtype, k
        np.testing.assert_array_equal(v, committed[k], err_msg=k)


@pytest.mark.parametrize("scene", sorted(exporter.SMALL_SCENES))
def test_small_scene_npz_equals_fresh_compile(scene):
    """The small scenes the kernels are tried on without the JAX package
    (nv = 7 damped, nv = 7 with contacts and a limit, nv = 96 undamped)."""
    fresh = exporter.model_to_numpy(exporter.small_scene(scene))
    path = {"box_chain": compat.BOX_CHAIN_MODEL,
            "ball_arm": compat.BALL_ARM_MODEL,
            "star96": compat.STAR96_MODEL}[scene]
    with np.load(path) as z:
        committed = {k: z[k] for k in z.files}
    assert sorted(fresh) == sorted(committed)
    for k, v in fresh.items():
        assert v.dtype == committed[k].dtype, k
        np.testing.assert_array_equal(v, committed[k], err_msg=k)
    m = compat.model_from_numpy(path, device="cpu")
    assert m.nv == {"box_chain": 7, "ball_arm": 7, "star96": 96}[scene]


def test_xml_is_the_generator_output():
    with open(tp.TWIN_XML) as f:
        assert f.read() == exporter.twin_xml()


def test_twin_dims_and_names():
    m = compat.model_from_numpy(compat.TWIN_MODEL, device="cpu")
    assert (m.nq, m.nv, m.nu, m.nbody, m.njnt) == (74, 73, 30, 65, 68)
    assert m.nlimit == 67 and m.ncon_max > 0
    assert float(m.dof_damping[6:].min()) > 0      # implicit damping
    assert float(m.dof_armature[6:].min()) > 0
    with open(f"{tp.ROOT}/configs/env_config.yaml") as f:
        cfg = yaml.safe_load(f)["env"]["env_args"]
    for k, v in RODENT_NAMES.items():
        assert cfg[k] == v, k
    for n in cfg["walker_body_names"] + ["hand_L", "hand_R", "skull"]:
        assert n in m.body_names
    for n in cfg["joint_names"]:
        assert n in m.joint_names


def test_twin_obs_and_traj_widths():
    from vnl_tpu_torch.envs import make_twin_env
    import torch
    env = make_twin_env(device="cpu")
    st = env.reset(2, generator=torch.Generator().manual_seed(0))
    assert st.obs.shape == (2, 232)
    assert st.info["traj"].shape == (2, 795)


@pytest.fixture(scope="module")
def keeper():
    with np.load(compat.KEEPER_POLICY) as z:
        return {k: z[k] for k in z.files}


def test_policy_round_trip(keeper):
    policy = compat.policy_from_numpy(keeper, device="cpu")
    assert policy.encoder.proj_0.weight.shape == (256, 795)
    assert policy.decoder.proj_0.weight.shape == (128, 296)
    assert policy.action_head.weight.shape == (60, 256)
    assert policy.obs_mean.shape == (232,)
    back = compat.policy_to_numpy(policy)
    assert sorted(back) == sorted(keeper)
    for k, v in keeper.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
