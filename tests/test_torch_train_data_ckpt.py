"""The port's data pipeline (``repro_torch.data.pipeline``) and checkpoint
manager (``repro_torch.checkpoint.manager``) against the JAX package's on
the CPU.

Batches equal JAX's bit for bit: at SMOKE vocab, and at llama's vocab
128256, where the int32 token walk wraps as the reference's does; with the
whisper / VLM extras and ``shard_for_host``.  Checkpoints go both ways:
JAX trains 4 steps and checkpoints, the port resumes and its losses at
steps 5-6 match JAX's straight run; the port's checkpoint restores in JAX's
``CheckpointManager`` bit for bit and JAX resumes from it.  Keep-k garbage
collection, and the shape / key checks of ``restore``."""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import llm_parity as lp
import train_parity as tp
from repro.checkpoint.manager import CheckpointManager as JaxCheckpointManager
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models.api import get_model as jax_get_model
from repro.optim import adamw as jadamw
from repro.train.loop import LoopConfig as JaxLoopConfig
from repro.train.loop import train as jax_train
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import base
from repro_torch.models.api import get_model
from repro_torch.optim import adamw
from repro_torch.train.loop import LoopConfig, train
from torch_threads import one_intra_op_thread  # noqa: F401


def _both(**kw):
    return JaxSyntheticLM(JaxDataConfig(**kw)), SyntheticLM(DataConfig(**kw))


def _equal_batches(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("vocab", [256, 2048, 32000, 128256, 151552])
@pytest.mark.parametrize("step", [0, 1, 17])
def test_batches_equal_jax(vocab, step):
    jd, d = _both(vocab=vocab, seq_len=24, global_batch=4, seed=step % 3)
    _equal_batches(jd.batch_at(step), d.batch_at(step))


def _walk_int64(cfg, step):
    """The same walk with exact (int64) arithmetic: what the reference's
    int32 product is not, once vocab**2 passes 2**31."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    B, S = cfg.global_batch, cfg.seq_len
    start = rng.integers(0, cfg.vocab, size=(B,))
    noise = rng.random(size=(B, S + 1))
    jump = rng.integers(0, cfg.vocab, size=(B, S + 1))
    toks = np.empty((B, S + 1), np.int64)
    toks[:, 0] = start
    a, c = 6364136223846793005 % cfg.vocab, 1442695040888963407 % cfg.vocab
    for t in range(1, S + 1):
        toks[:, t] = np.where(noise[:, t] < 0.8, (toks[:, t - 1] * a + c) % cfg.vocab,
                              jump[:, t])
    return toks


@pytest.mark.parametrize("vocab,wraps", [(256, False), (32000, False), (128256, True)])
def test_token_walk_keeps_the_int32_wrap(vocab, wraps):
    """At vocab 128256 a followed token of 128000 gives 55375 (exact:
    102991): the port keeps the reference's wrap, so its batches are JAX's."""
    jd, d = _both(vocab=vocab, seq_len=64, global_batch=4)
    got = d.batch_at(0)["tokens"]
    np.testing.assert_array_equal(got, jd.batch_at(0)["tokens"])
    exact = _walk_int64(d.cfg, 0)
    assert (not np.array_equal(got, exact)) == wraps
    if vocab == 128256:
        a, c = 6364136223846793005 % vocab, 1442695040888963407 % vocab
        one = np.array([128000], np.int32)
        assert int(((one * a + c) % vocab)[0]) == 55375 and (128000 * a + c) % vocab == 102991


@pytest.mark.parametrize("extras", [
    {"frames_dim": 64, "n_frames": 24},                  # whisper
    {"img_dim": 64, "n_patches": 16},                    # vlm
    {"frames_dim": 8, "n_frames": 3, "img_dim": 8, "n_patches": 5},
])
def test_modality_extras_equal_jax(extras):
    jd, d = _both(vocab=256, seq_len=24, global_batch=4, seed=2, **extras)
    for step in (0, 5):
        _equal_batches(jd.batch_at(step), d.batch_at(step))


@pytest.mark.parametrize("num_hosts", [1, 2, 3, 4])
def test_shard_for_host_equals_jax(num_hosts):
    jd, d = _both(vocab=256, seq_len=8, global_batch=12, frames_dim=4, n_frames=8)
    batch = d.batch_at(3)
    shards = [d.shard_for_host(batch, h, num_hosts) for h in range(num_hosts)]
    for h, s in enumerate(shards):
        _equal_batches(jd.shard_for_host(jd.batch_at(3), h, num_hosts), s)
    np.testing.assert_array_equal(np.concatenate([s["tokens"] for s in shards]),
                                  batch["tokens"])


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------
JTINY = dataclasses.replace(tp.JAX_TINY, dtype="float32")
TINY = tp.f32(tp.TINY)


def _setup():
    dc = dict(vocab=TINY.vocab, seq_len=16, global_batch=4, seed=1)
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=30)
    return ((jax_get_model(JTINY), JaxSyntheticLM(JaxDataConfig(**dc)),
             jadamw.AdamWConfig(**ocfg)),
            (get_model(TINY), SyntheticLM(DataConfig(**dc)), adamw.AdamWConfig(**ocfg)))


def _rel(a, b):
    return abs(a - b) / max(1.0, abs(b))


def test_port_resumes_from_a_jax_checkpoint(tmp_path, capsys):
    (jm, jd, jo), (m, d, o) = _setup()
    _, _, straight = jax_train(jm, jd, jo, JaxLoopConfig(steps=6, ckpt_dir=None, log_every=100))
    ck = str(tmp_path / "ck")
    jax_train(jm, jd, jo, JaxLoopConfig(steps=4, ckpt_every=4, ckpt_dir=ck, log_every=100))
    capsys.readouterr()
    _, state, hist = train(m, d, o, LoopConfig(steps=6, ckpt_every=100, ckpt_dir=ck,
                                               log_every=100), device="cpu")
    assert "[resume] from step 4" in capsys.readouterr().out
    assert [r["step"] for r in hist] == [5, 6]
    assert int(state.step) == 6 and state.step.device.type == "cpu"
    for got, want in zip(hist, straight[4:]):
        assert _rel(got["loss"], want["loss"]) <= lp.F32_TOL, (got, want)


def test_jax_restores_a_port_checkpoint_bit_for_bit(tmp_path, capsys):
    (jm, jd, jo), (m, d, o) = _setup()
    ck = str(tmp_path / "ck")
    params, state, _ = train(m, d, o, LoopConfig(steps=3, ckpt_every=3, ckpt_dir=ck,
                                                 log_every=100), device="cpu")
    jparams = jm.init_params(jax.random.PRNGKey(0))
    like = {"params": jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jparams),
            "opt": jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                                jadamw.init(jparams))}
    step, restored = JaxCheckpointManager(ck).restore_latest(like)
    assert step == 3
    got = jax.tree.map(np.asarray, restored)
    for name, t in base.named_leaves(params):
        want = dict(base.named_leaves(got["params"]))[name]
        np.testing.assert_array_equal(want, t.numpy(), err_msg=name)
    for field in ("m", "v"):
        for name, t in base.named_leaves(getattr(state, field)):
            want = dict(base.named_leaves(getattr(got["opt"], field)))[name]
            np.testing.assert_array_equal(want, t.numpy(), err_msg=f"{field} {name}")
    assert got["opt"].step.dtype == np.int32 and int(got["opt"].step) == 3
    # ... and JAX's loop continues from it as the port's does
    _, _, port_straight = train(m, d, o, LoopConfig(steps=5, ckpt_dir=None, log_every=100),
                                device="cpu")
    capsys.readouterr()
    _, _, jhist = jax_train(jm, jd, jo, JaxLoopConfig(steps=5, ckpt_every=100, ckpt_dir=ck,
                                                      log_every=100))
    assert "[resume] from step 3" in capsys.readouterr().out
    for got, want in zip(jhist, port_straight[3:]):
        assert got["step"] == want["step"]
        assert _rel(got["loss"], want["loss"]) <= lp.F32_TOL, (got, want)


def test_keys_and_files_are_jax_s(tmp_path):
    """The same tree saved by both packages: the same keys (tree paths
    joined by '/', ``opt/m/blocks/attn/wq``), files and sidecars."""
    jparams = jax_get_model(JTINY).init_params(jax.random.PRNGKey(0))
    jstate = jadamw.init(jparams)
    params = base.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    state = adamw.init(params)
    jpath = JaxCheckpointManager(str(tmp_path / "j")).save(
        2, {"params": jparams, "opt": jstate._asdict()})
    path = CheckpointManager(str(tmp_path / "p")).save(
        2, {"params": params, "opt": state._asdict()})
    assert os.path.basename(path) == os.path.basename(jpath) == "ckpt_00000002.npz"
    with np.load(jpath) as zj, np.load(path) as zp:
        assert sorted(zj.files) == sorted(zp.files)
        assert "opt/m/blocks/attn/wq" in zp.files and "params/tok_embed" in zp.files
        for k in zj.files:
            assert zj[k].dtype == zp[k].dtype and zj[k].shape == zp[k].shape, k
            np.testing.assert_array_equal(zj[k], zp[k], err_msg=k)
    assert os.path.exists(path + ".json")


def test_keep_k_garbage_collection(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    assert mgr.latest_step() is None and mgr.restore_latest({"a": torch.zeros(1)}) == (None, None)
    for s in (1, 2, 3, 5, 8):
        mgr.save(s, {"a": torch.full((2,), float(s))})
    assert mgr.all_steps() == [5, 8] and mgr.latest_step() == 8
    names = sorted(os.listdir(tmp_path))
    assert names == ["ckpt_00000005.npz", "ckpt_00000005.npz.json",
                     "ckpt_00000008.npz", "ckpt_00000008.npz.json"]
    step, tree = mgr.restore_latest({"a": torch.zeros(2)}, device="cpu")
    assert step == 8 and torch.equal(tree["a"], torch.full((2,), 8.0))


def test_restore_checks_shapes_keys_and_keeps_dtypes(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = adamw.AdamWState(torch.tensor(4, dtype=torch.int32), {"w": torch.ones(2, 3)},
                             {"w": torch.ones(2, 3)})
    mgr.save(4, {"params": {"w": torch.arange(6.0).reshape(2, 3)}, "opt": state._asdict()})
    like = {"params": {"w": torch.empty(2, 3, device="meta")}, "opt": state}
    out = mgr.restore(4, like, device="cpu")
    assert isinstance(out["opt"], adamw.AdamWState)
    assert out["opt"].step.dtype == torch.int32 and int(out["opt"].step) == 4
    assert torch.equal(out["params"]["w"], torch.arange(6.0).reshape(2, 3))
    bf = mgr.restore(4, {"params": {"w": torch.empty(2, 3, dtype=torch.bfloat16)}},
                     device="cpu")
    assert bf["params"]["w"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="checkpoint shape"):
        mgr.restore(4, {"params": {"w": torch.empty(3, 2)}}, device="cpu")
    with pytest.raises(KeyError, match="checkpoint missing params/x"):
        mgr.restore(4, {"params": {"x": torch.empty(2, 3)}}, device="cpu")


def test_restore_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.zeros(1)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mgr.restore(1, {"a": torch.zeros(1)})
