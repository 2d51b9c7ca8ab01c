"""Shared helpers of the sharded-step tests (``tests/test_torch_sharded_*.py``):
the SMOKE models, inputs, one train step, cached decode, and the rank
function run on gloo worlds of 4 CPU ranks.  The bounds are stated in
``tests/test_torch_sharded_train.py``."""
import dataclasses

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import SMOKE
from repro_torch.models import base
from repro_torch.models.api import get_model
from repro_torch.optim import adamw
from repro_torch.train import steps

B, S = 4, 32
TOL = 1e-5
FULL = "llama3.2-1b"
ARCHS = sorted(SMOKE)


def cfg_of(arch):
    return dataclasses.replace(SMOKE[arch], dtype="float32")


def setup(arch):
    """(model, params, batch) of ``arch``: the same on every rank."""
    cfg = cfg_of(arch)
    model = get_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, size=(B, S + 1)).astype(np.int32))}
    if cfg.family == "whisper":
        batch["frames"] = torch.from_numpy(rng.normal(size=(B, S, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        batch["img_embeds"] = torch.from_numpy(
            rng.normal(size=(B, cfg.n_img_patches, cfg.d_model)).astype(np.float32))
    return model, params, batch


def train_step(model, params, batch, compression=None):
    """(loss, grads, updated params) of one train step."""
    (loss, _), grads = steps.value_and_grad(model, params, batch)
    step = steps.make_train_step(model, adamw.AdamWConfig(), grad_compression=compression)
    new, _, metrics = step(params, adamw.init(params), batch)
    return loss, grads, new


def decode(model, params, n=2):
    """Logits of ``n`` cached decode steps from zero caches."""
    caches = model.init_caches(B, 16, device="cpu")
    token = torch.arange(B, dtype=torch.int32).reshape(B, 1) + 5
    out = []
    with torch.no_grad():
        for pos in range(n):
            logits, caches = model.decode_logits(params, caches, token, pos)
            out.append(logits)
            token = torch.argmax(logits, dim=-1).to(torch.int32)
    return out


def to_numpy(tree):
    """Every leaf as numpy, a DTensor gathered first (every rank calls it)."""
    from torch.distributed.tensor import DTensor
    return base.tree_map(
        lambda x: (x.full_tensor() if isinstance(x, DTensor) else x).detach().numpy(), tree)


def sharded_rank(mesh, rank, archs, ckpt_dir, extras):
    """One rank: every arch's sharded step (loss; grads and new params of
    FULL), and on request the checkpoint, decode and int8 cases."""
    from torch.distributed.tensor import DTensor

    from repro_torch.parallel import sharding

    out = {}
    for arch in archs:
        model, params, batch = setup(arch)
        pl = sharding.param_shardings(model.param_defs(), mesh, fsdp=True)
        dparams = sharding.distribute(params, mesh, pl)
        bpl = base.tree_map(lambda s: sharding.placements(s, mesh),
                            sharding.batch_pspecs(batch, mesh))
        dbatch = sharding.distribute(batch, mesh, bpl)
        with sharding.use_mesh(mesh, fsdp=True):
            if arch == FULL:
                loss, grads, new = train_step(model, dparams, dbatch)
                res = {"loss": float(loss.full_tensor()),
                       "grads": to_numpy(grads), "params": to_numpy(new)}
                res["sharded"] = sum(isinstance(x, DTensor) and
                                     any(not p.is_replicate() for p in x.placements)
                                     for _, x in base.named_leaves(new))
            else:                        # the loss alone: the forward pass
                with torch.no_grad():
                    res = {"loss": float(model.loss_fn(dparams, dbatch)[0].full_tensor())}
        out[arch] = res
    if "ckpt" in extras:
        model, params, _ = setup(FULL)
        pl = sharding.param_shardings(model.param_defs(), mesh, fsdp=True)
        got = CheckpointManager(ckpt_dir).restore(0, model.param_shapes(),
                                                  shardings=pl, mesh=mesh)
        out["restored"] = to_numpy(got)
        out["restored_placements"] = {n: tuple(x.placements)
                                      for n, x in base.named_leaves(got)}
        out["placements"] = dict(base.named_leaves(pl))
        # a sharded save: every rank gathers, rank 0 writes the full tensors
        CheckpointManager(ckpt_dir).save(1, sharding.distribute(params, mesh, pl))
    if "decode" in extras:
        model, params, _ = setup(FULL)
        pl = sharding.param_shardings(model.param_defs(), mesh, fsdp=True)
        dparams = sharding.distribute(params, mesh, pl)
        caches = model.init_caches(B, 16, device="cpu")
        cpl = base.tree_map(lambda s: sharding.placements(s, mesh),
                            sharding.cache_pspecs(caches, mesh))
        dcaches = sharding.distribute(caches, mesh, cpl)
        token = torch.arange(B, dtype=torch.int32).reshape(B, 1) + 5
        logits_out = []
        with sharding.use_mesh(mesh, fsdp=True), torch.no_grad():
            for pos in range(2):
                logits, dcaches = model.decode_logits(dparams, dcaches, token, pos)
                logits = logits.full_tensor()
                logits_out.append(logits.numpy())
                token = torch.argmax(logits, dim=-1).to(torch.int32)
        out["decode"] = logits_out
        out["kv_placements"] = tuple(dcaches["k"].placements)
    if "int8" in extras:
        model, params, batch = setup(FULL)
        pl = sharding.param_shardings(model.param_defs(), mesh, fsdp=True)
        dparams = sharding.distribute(params, mesh, pl)
        bpl = base.tree_map(lambda s: sharding.placements(s, mesh),
                            sharding.batch_pspecs(batch, mesh))
        with sharding.use_mesh(mesh, fsdp=True):
            _, _, new = train_step(model, dparams, sharding.distribute(batch, mesh, bpl), "int8")
        out["int8"] = to_numpy(new)
    return out if rank == 0 else None


def single_reference():
    """FULL's single-device loss, grads and updated parameters, and the
    grads' own change under a one-ulp (2**-24 relative) perturbation of
    the parameters, per leaf."""
    model, params, batch = setup(FULL)
    loss, grads, new = train_step(model, params, batch)
    gen = torch.Generator().manual_seed(7)
    nudged = base.tree_map(
        lambda p: p * (1 + 2.0 ** -24 * torch.randn(p.shape, generator=gen)), params)
    (_, _), g2 = steps.value_and_grad(model, nudged, batch)
    own = {n: float((a - b).abs().max())
           for (n, a), (_, b) in zip(base.named_leaves(grads), base.named_leaves(g2))}
    return float(loss), to_numpy(grads), to_numpy(new), own


def close_per_leaf(got, want, what, own=None):
    """Every leaf within TOL of its largest magnitude (or twice ``own``)."""
    names = [n for n, _ in base.named_leaves(want)]
    assert [n for n, _ in base.named_leaves(got)] == names
    for (name, g), (_, w) in zip(base.named_leaves(got), base.named_leaves(want)):
        bound = TOL * max(float(np.abs(w).max()), 1e-30)
        if own is not None:
            bound = max(bound, 2 * own[name])
        err = float(np.abs(g - w).max())
        assert err <= bound, f"{what} {name}: {err:.3e} > {bound:.3e}"


def check_full(res, single, what):
    """FULL's sharded step (``res``) against the single-device one."""
    loss, grads, new, own = single
    assert abs(res["loss"] - loss) <= TOL * abs(loss)
    close_per_leaf(res["grads"], grads, f"{what} grad", own)
    close_per_leaf(res["params"], new, f"{what} param")
    assert res["sharded"] > 0               # the leaves really were sharded
