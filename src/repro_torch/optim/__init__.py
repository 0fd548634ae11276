"""Optimizers over the gradient pool: momentum SGD, LARS (momentum SGD
under per-tensor trust ratios, ``optim.lars``) and AdamW, and the numeric
guard's loss scaler (``optim.scaler``). Every update takes the guard's
device verdict ``ok``: when it is false the update writes nothing."""
from repro_torch.kernels import ref
from repro_torch.optim import adamw, lars, scaler, schedules, sgd
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.schedules import lr_at
from repro_torch.optim.sgd import SGDState


def _module(name: str):
    if name in ("momentum_sgd", "lars"):
        return sgd
    if name == "adamw":
        return adamw
    raise ValueError(f"unknown optimizer {name}")


def state_type(name: str) -> type:
    """The optimizer state's NamedTuple: ``SGDState`` or ``AdamWState``."""
    return SGDState if _module(name) is sgd else AdamWState


def init_state(name: str, pool_size: int, device=None):
    return _module(name).init(pool_size, device=device)


def update_pool(name: str, *args, **kwargs):
    """The whole-pool update: (new master pool, new optimizer state), as
    new tensors. 'lars' is momentum SGD with the caller's per-element
    ``scale``."""
    return _module(name).update_pool(*args, **kwargs)


def _adamw_update(table, master, grads, state, mask, cfg, lr, scale, ratios,
                  out_leaves, ok=None):
    """AdamW has no fused kernel: ``update_pool`` on the pool or segment
    that ``table`` (a ``GradientPool`` or a ``PoolView``) lays out, then
    the new state and the leaves written back in place (the engine counts
    on it). With the guard's verdict ``ok`` the write-back is
    ``ref.commit_where`` (the leaves must be given). Returns (1-D leaves in
    their declared dtype, ``state``)."""
    if ratios is not None:
        assert scale is None
        scale = ref.expand_ratios(ratios, table.sizes, table.size)
    new_master, new_state = adamw.update_pool(master, grads, state, mask,
                                              cfg, lr, scale=scale)
    leaves = [new_master[o:o + s] for o, s in zip(table.offsets, table.sizes)]
    if ok is not None:
        if out_leaves is None:
            raise ValueError("ok needs the live parameters as out_leaves")
        ref.commit_where(ok, leaves + list(new_state),
                         list(out_leaves) + list(state))
        leaves = list(out_leaves)
    else:
        if out_leaves is not None:
            leaves = [dst.copy_(src) for dst, src in zip(out_leaves, leaves)]
        for dst, src in zip(state, new_state):
            dst.copy_(src)
    leaves = [x if x.dtype == spec.dtype else x.to(spec.dtype)
              for x, spec in zip(leaves, table.specs)]
    return leaves, state


def update_unpack(name: str, pool, master, grads, state, mask, cfg, lr, *,
                  scale=None, ratios=None, use_kernels: bool = False,
                  out_leaves=None, ok=None):
    """Fused update + unravel over the whole pool: (new params tree, new
    optimizer state). SGD and LARS run the update kernel (LARS as the
    per-tensor ``ratios``); AdamW falls back to ``update_pool`` and
    slices. The state, and the parameter leaves ``out_leaves`` when
    given, are written in place; where the guard's ``ok`` is false,
    nothing is."""
    if _module(name) is sgd:
        return sgd.update_unpack(pool, master, grads, state, mask, cfg, lr,
                                 scale=scale, ratios=ratios,
                                 use_kernels=use_kernels,
                                 out_leaves=out_leaves, ok=ok)
    leaves, st = _adamw_update(pool, master, grads, state, mask, cfg, lr,
                               scale, ratios, out_leaves, ok)
    return pool.unflatten(leaves), st


def update_view(name: str, view, master, grads, state, mask, cfg, lr, *,
                scale=None, ratios=None, use_kernels: bool = False,
                out_leaves=None, ok=None):
    """Per-bucket segment update, the overlap engine's retire step: every
    array is a span-relative segment (the state's pool-sized leaves
    sliced to the span). Returns (1-D leaves of the view's tensors, new
    state segment); the state segment and ``out_leaves`` are written in
    place."""
    if _module(name) is sgd:
        return sgd.update_view(view, master, grads, state, mask, cfg, lr,
                               scale=scale, ratios=ratios,
                               use_kernels=use_kernels,
                               out_leaves=out_leaves, ok=ok)
    return _adamw_update(view, master, grads, state, mask, cfg, lr, scale,
                         ratios, out_leaves, ok)


__all__ = ["AdamWState", "SGDState", "adamw", "init_state", "lars", "lr_at",
           "scaler", "schedules", "sgd", "state_type", "update_pool", "update_unpack",
           "update_view"]
