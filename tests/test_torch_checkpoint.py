"""The port's checkpointing (``repro_torch.checkpoint``) and data pipeline
against the reference's.

Counterparts of every case in ``tests/test_checkpoint_data.py``, then the
format across packages: a checkpoint written by the reference's
``save_tree`` restores through the port's ``restore_tree`` and the reverse,
bit for bit, bf16 leaves included, and the manager's async save writes the
state as it was when ``save`` returned, whatever the caller does to it next.
"""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's host has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore_tree as ref_restore_tree
from repro.checkpoint import save_tree as ref_save_tree
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.configs.registry import get_arch as ref_get_arch
from repro.data.synthetic import SyntheticLM as RefSyntheticLM

from repro_torch.checkpoint import CheckpointManager, latest_step, restore_tree, save_tree
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_arch
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch import train
from repro_torch.models.model import model_spec
from repro_torch.models.spec import init_params
from repro_torch.optim import make_optimizer, tree_leaves


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.tensor(rng.standard_normal((4, 4)), dtype=torch.float32),
                   "b": torch.tensor(rng.standard_normal(4)).to(torch.bfloat16),
                   "s": torch.tensor(1.5, dtype=torch.bfloat16)},
        "opt": [torch.zeros(3), torch.ones(2, dtype=torch.int32)],
    }


def _ref_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": jnp.asarray(rng.standard_normal((4, 4)), jnp.float32),
                   "b": jnp.asarray(rng.standard_normal(4), jnp.bfloat16),
                   "s": jnp.asarray(1.5, jnp.bfloat16)},
        "opt": [jnp.zeros(3), jnp.ones(2, jnp.int32)],
    }


def _leaves(tree):
    """(path, raw bytes, dtype name, shape) of every leaf of either package's tree."""
    from repro.checkpoint.ckpt import _flatten_with_paths

    out = []
    for path, v in _flatten_with_paths(tree):
        if isinstance(v, torch.Tensor):
            name = str(v.dtype).removeprefix("torch.")
            raw = (v.view(torch.int16) if v.dtype == torch.bfloat16 else v).numpy().tobytes()
            out.append((path, raw, name, tuple(v.shape)))
        else:
            v = np.asarray(v)
            out.append((path, v.tobytes(), v.dtype.name, v.shape))
    return out


def test_save_restore_bitwise_roundtrip(tmp_path):
    tree = _tree()
    save_tree(str(tmp_path), 7, tree)
    got = restore_tree(str(tmp_path), 7, tree, device="cpu")
    assert _leaves(got) == _leaves(tree)


def test_no_tmp_litter_and_latest_step(tmp_path):
    tree = _tree()
    save_tree(str(tmp_path), 1, tree)
    save_tree(str(tmp_path), 5, tree)
    assert latest_step(str(tmp_path)) == 5
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]
    assert latest_step(str(tmp_path / "absent")) is None


def test_manager_retention_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    tree = _tree()
    for s in range(5):
        mgr.save(s, tree)
    mgr.wait()
    steps = sorted(int(f[5:13]) for f in os.listdir(tmp_path) if f.endswith(".json"))
    assert steps == [3, 4]
    got, step = mgr.restore(tree, device="cpu")
    assert step == 4 and got is not None


def test_restore_is_template_independent(tmp_path):
    """Leaves are saved whole: any template of the same structure restores them."""
    tree = _tree(1)
    save_tree(str(tmp_path), 0, tree)
    template = {"params": {k: torch.empty(0) for k in tree["params"]},
                "opt": [torch.empty(0), torch.empty(0)]}
    got = restore_tree(str(tmp_path), 0, template, device="cpu")
    assert _leaves(got) == _leaves(tree)
    as_f32 = restore_tree(str(tmp_path), 0, template, device="cpu", dtypes={
        "params": {k: torch.float32 for k in tree["params"]},
        "opt": [torch.float32, torch.float32]})
    assert all(x.dtype == torch.float32 for x in tree_leaves(as_f32["params"]))
    np.testing.assert_array_equal(as_f32["params"]["b"].numpy(),
                                  tree["params"]["b"].float().numpy())


def test_restore_defaults_to_the_card(tmp_path):
    tree = _tree()
    save_tree(str(tmp_path), 0, tree)
    if torch.cuda.is_available():
        assert restore_tree(str(tmp_path), 0, tree)["params"]["w"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            restore_tree(str(tmp_path), 0, tree)


def test_numpy_leaves_stay_numpy(tmp_path):
    tree = (np.arange(8.0), np.zeros(3, np.int32))
    save_tree(str(tmp_path), 2, tree)
    got = restore_tree(str(tmp_path), 2, tree)   # no tensor leaf: no device needed
    assert isinstance(got, tuple) and all(isinstance(x, np.ndarray) for x in got)
    np.testing.assert_array_equal(got[0], tree[0])


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    ref = _ref_tree(2)
    ref_save_tree(str(tmp_path), 3, ref)
    got = restore_tree(str(tmp_path), 3, _tree(), device="cpu")
    assert _leaves(got) == _leaves(ref)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _tree(3)
    save_tree(str(tmp_path), 4, tree)
    got = ref_restore_tree(str(tmp_path), 4, _ref_tree())
    assert _leaves(got) == _leaves(tree)


def test_manifests_agree(tmp_path):
    ref_save_tree(str(tmp_path / "ref"), 1, _ref_tree(4))
    save_tree(str(tmp_path / "port"), 1, _tree(4))
    ref, port = (json.loads((tmp_path / d / "step_00000001.json").read_text())
                 for d in ("ref", "port"))
    assert ref["leaves"] == port["leaves"] and ref["step"] == port["step"] == 1


def test_train_state_crosses_packages(tmp_path):
    """A bf16 model and its AdamW state saved by the port restore in the
    reference under the reference's own leaf paths, and back."""
    from repro.models.model import model_spec as ref_model_spec
    from repro.models.spec import init_params as ref_init_params
    from repro.optim import make_optimizer as ref_make_optimizer

    cfg = get_arch("granite-3-2b").reduced()
    params = init_params(model_spec(cfg), seed=0, device="cpu")
    opt = make_optimizer("adamw", lambda s: 1e-3)
    state = (params, opt.init(params))
    save_tree(str(tmp_path), 0, state)
    rcfg = ref_get_arch("granite-3-2b").reduced()
    rp = ref_init_params(ref_model_spec(rcfg), seed=1)
    ref_state = ref_restore_tree(str(tmp_path), 0,
                                 (rp, ref_make_optimizer("adamw", lambda s: 1e-3).init(rp)))
    assert _leaves(ref_state) == _leaves(state)
    ref_save_tree(str(tmp_path / "back"), 0, ref_state)
    back = restore_tree(str(tmp_path / "back"), 0, state, device="cpu")
    assert _leaves(back) == _leaves(state)


def test_async_save_snapshots_before_returning(tmp_path):
    """The optimizer updates parameters in place: what ``save`` writes is the
    tree as it was when ``save`` returned."""
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    tree = {"w": torch.zeros(256, 256)}
    mgr.save(0, tree)
    tree["w"].add_(1.0)      # the next step's in-place update
    mgr.wait()
    assert float(restore_tree(str(tmp_path), 0, tree, device="cpu")["w"].abs().max()) == 0.0


def test_async_save_failure_surfaces_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=3, async_save=True)
    (tmp_path / "blocker").write_text("")
    mgr.path = str(tmp_path / "blocker")     # a file where the directory should be
    mgr.save(0, _tree())
    with pytest.raises(FileExistsError):
        mgr.wait()
    mgr.wait()                               # raised once: the manager is usable again


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------


def test_data_is_deterministic_and_seekable():
    cfg = get_arch("internlm2-1.8b").reduced()
    shape = ShapeConfig("t", 64, 4, "train")
    d1 = SyntheticLM(cfg, shape, seed=3)
    d2 = SyntheticLM(cfg, shape, seed=3)
    for step in (0, 17, 123456):
        b1, b2 = d1.batch(step), d2.batch(step)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
        np.testing.assert_array_equal(b1["labels"], b2["labels"])
    # different steps differ
    assert not np.array_equal(d1.batch(0)["tokens"], d1.batch(1)["tokens"])


def test_labels_are_shifted_tokens():
    cfg = get_arch("granite-3-2b").reduced()
    d = SyntheticLM(cfg, ShapeConfig("t", 32, 2, "train"), seed=0)
    b = d.batch(5)
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert (b["labels"][:, -1] == -1).all()
    assert (b["tokens"] >= 0).all() and (b["tokens"] < cfg.vocab).all()


def test_frontend_stubs_present():
    wcfg = get_arch("whisper-medium").reduced()
    b = SyntheticLM(wcfg, ShapeConfig("t", 16, 2, "train")).batch(0)
    assert b["enc_embeds"].shape == (2, wcfg.encoder.n_ctx, wcfg.d_model)
    vcfg = get_arch("llama-3.2-vision-90b").reduced()
    b = SyntheticLM(vcfg, ShapeConfig("t", 16, 2, "train")).batch(0)
    assert b["img_embeds"].shape == (2, vcfg.n_img_tokens, vcfg.d_model)


@pytest.mark.parametrize("arch", ["granite-3-2b", "whisper-medium", "llama-3.2-vision-90b"])
def test_batches_equal_the_reference(arch):
    shape = ("t", 24, 2, "train")
    ref = RefSyntheticLM(ref_get_arch(arch).reduced(), RefShapeConfig(*shape), seed=5).batch(9)
    got = SyntheticLM(get_arch(arch).reduced(), ShapeConfig(*shape), seed=5).batch(9)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


def test_train_batches_come_from_the_seekable_pipeline():
    """``launch.train``'s batches are ``SyntheticLM``'s at the step asked for."""
    run = train.build(train.parse_args(["--arch", "whisper-medium", "--device", "cpu",
                                        "--batch", "2", "--seq", "16"]))
    want = SyntheticLM(run.cfg, ShapeConfig("t", 16, 2, "train"), seed=0).batch(7)
    got = run.batch_fn(7)
    np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])
    assert got["tokens"].dtype == torch.long
    assert got["enc_embeds"].dtype == torch.bfloat16
