"""Optimizers over the gradient pool. The port has momentum SGD (and, for
``update_pool``, LARS's per-element scaled form of it); LARS's ratios,
AdamW and the loss scaler are not ported yet (ROADMAP.md queue A)."""
from repro_torch.optim import schedules, sgd
from repro_torch.optim.schedules import lr_at
from repro_torch.optim.sgd import SGDState


def _check(name: str) -> None:
    if name != "momentum_sgd":
        raise NotImplementedError(
            f"optimizer {name!r} is not ported to repro_torch yet; see "
            "ROADMAP.md queue A")


def init_state(name: str, pool_size: int, device=None) -> SGDState:
    _check(name)
    return sgd.init(pool_size, device=device)


def update_pool(name: str, *args, **kwargs):
    """The whole-pool update: (new master pool, new optimizer state).
    'lars' is momentum SGD with the caller's per-element ``scale``."""
    if name in ("momentum_sgd", "lars"):
        return sgd.update_pool(*args, **kwargs)
    if name == "adamw":
        raise NotImplementedError(
            "optimizer 'adamw' is not ported to repro_torch yet; see "
            "ROADMAP.md queue A")
    raise ValueError(f"unknown optimizer {name}")


def update_unpack(name: str, pool, master, grads, state, mask, cfg, lr,
                  **kwargs):
    """Fused update + unravel: (new params tree, new optimizer state)."""
    _check(name)
    return sgd.update_unpack(pool, master, grads, state, mask, cfg, lr,
                             **kwargs)


def update_view(name: str, view, master, grads, state, mask, cfg, lr,
                **kwargs):
    """Per-bucket segment update, the overlap engine's retire step:
    (leaves of the view's tensors, new state segment)."""
    _check(name)
    return sgd.update_view(view, master, grads, state, mask, cfg, lr,
                           **kwargs)


__all__ = ["SGDState", "init_state", "lr_at", "schedules", "sgd",
           "update_pool", "update_unpack", "update_view"]
