"""Optimizer and lr-scheduler factory for the training CLI (counterpart of
``bde2vid_tpu/train/optim.py``).

The reference's config system (parse_config.py:84-112) reflection-builds
``torch.optim`` optimizers and ``torch.optim.lr_scheduler`` schedulers from
json sections ``{"type": Name, "args": {...}}``; here they map onto those
classes directly: Adam (L2-coupled decay), AdamW (decoupled, 1e-2 by
default), SGD (momentum, nesterov), RMSprop; StepLR, MultiStepLR,
ExponentialLR, CosineAnnealingLR, LinearLR. The scheduler steps once per
optimizer step, so boundaries are in train steps, as in the JAX package.
``grad_clip`` is global-norm clipping (``clip_grad_norm_``) before the
update.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Tuple

import torch


def _canon(cfg: Optional[Dict[str, Any]], default_type: str) -> Tuple[str, Dict]:
    """Accept ``{"type": Name, "args": {...}}`` and the flat shape
    ``{"lr": ...}`` (a bare ``{"lr": 1e-4}`` is Adam)."""
    cfg = dict(cfg or {})
    name = str(cfg.pop("type", default_type))
    args = dict(cfg.pop("args", {}))
    overlap = set(args) & set(cfg)
    if overlap:
        raise ValueError(f"config keys duplicated inside and outside 'args': {sorted(overlap)}")
    args.update(cfg)
    return name, args


def build_schedule(optimizer: torch.optim.Optimizer,
                   scheduler_cfg: Optional[Dict[str, Any]]) -> Tuple[Any, str]:
    """``lr_scheduler`` config -> (``torch.optim.lr_scheduler`` instance or
    None for a constant lr, description)."""
    sched = torch.optim.lr_scheduler
    base_lr = optimizer.param_groups[0]["lr"]
    if not scheduler_cfg:
        return None, f"constant(lr={base_lr:g})"
    name, a = _canon(scheduler_cfg, "StepLR")
    key = name.lower()
    if key == "steplr":
        kw = dict(step_size=int(a.pop("step_size")), gamma=float(a.pop("gamma", 0.1)))
        s = sched.StepLR(optimizer, **kw)
        desc = f"StepLR(step_size={kw['step_size']}, gamma={kw['gamma']:g})"
    elif key == "multisteplr":
        milestones = sorted(int(m) for m in a.pop("milestones"))
        gamma = float(a.pop("gamma", 0.1))
        s = sched.MultiStepLR(optimizer, milestones=milestones, gamma=gamma)
        desc = f"MultiStepLR(milestones={milestones}, gamma={gamma:g})"
    elif key == "exponentiallr":
        gamma = float(a.pop("gamma"))
        s = sched.ExponentialLR(optimizer, gamma=gamma)
        desc = f"ExponentialLR(gamma={gamma:g})"
    elif key == "cosineannealinglr":
        t_max, eta_min = int(a.pop("T_max")), float(a.pop("eta_min", 0.0))
        s = sched.CosineAnnealingLR(optimizer, T_max=t_max, eta_min=eta_min)
        desc = f"CosineAnnealingLR(T_max={t_max}, eta_min={eta_min:g})"
    elif key == "linearlr":
        start = float(a.pop("start_factor", 1.0 / 3.0))
        end = float(a.pop("end_factor", 1.0))
        total = int(a.pop("total_iters", 5))
        s = sched.LinearLR(optimizer, start_factor=start, end_factor=end, total_iters=total)
        desc = f"LinearLR(start_factor={start:g}, end_factor={end:g}, total_iters={total})"
    else:
        raise ValueError(
            f"unknown lr_scheduler type {name!r} (supported: StepLR, MultiStepLR, "
            "ExponentialLR, CosineAnnealingLR, LinearLR)"
        )
    if a:
        raise ValueError(f"unknown {name} args: {sorted(a)}")
    return s, desc


def build_optimizer(params: Iterable[torch.nn.Parameter],
                    optimizer_cfg: Optional[Dict[str, Any]] = None,
                    scheduler_cfg: Optional[Dict[str, Any]] = None):
    """Json config sections -> ``(optimizer, scheduler or None, grad_clip or
    None, description)``. Keys are torch's (``lr``, ``weight_decay``,
    ``betas``, ``eps``, ``momentum``, ``nesterov``, ``alpha``, ``centered``)
    plus ``grad_clip``, the global norm to clip gradients to before each
    update."""
    name, a = _canon(optimizer_cfg, "Adam")
    key = name.lower()
    lr = float(a.pop("lr", 1e-4))
    grad_clip = a.pop("grad_clip", None)
    # torch defaults differ by optimizer: AdamW decays at 1e-2 unless told
    # otherwise, the others not at all; an explicit 0 wins
    wd_raw = a.pop("weight_decay", None)
    wd = float(wd_raw) if wd_raw is not None else (1e-2 if key == "adamw" else 0.0)
    params = list(params)
    if key in ("adam", "adamw"):
        b1, b2 = a.pop("betas", (0.9, 0.999))
        eps = float(a.pop("eps", 1e-8))
        cls = torch.optim.Adam if key == "adam" else torch.optim.AdamW
        opt = cls(params, lr=lr, betas=(float(b1), float(b2)), eps=eps, weight_decay=wd)
        desc = f"{cls.__name__}(lr={lr:g}, betas=({b1}, {b2}), weight_decay={wd:g})"
    elif key == "sgd":
        momentum = float(a.pop("momentum", 0.0))
        nesterov = bool(a.pop("nesterov", False))
        if momentum and float(a.pop("dampening", 0.0)):
            raise ValueError("SGD dampening is not supported")
        a.pop("dampening", None)
        opt = torch.optim.SGD(params, lr=lr, momentum=momentum, nesterov=nesterov, weight_decay=wd)
        desc = f"SGD(lr={lr:g}, momentum={momentum:g}, nesterov={nesterov}, weight_decay={wd:g})"
    elif key == "rmsprop":
        alpha = float(a.pop("alpha", 0.99))
        eps = float(a.pop("eps", 1e-8))
        momentum = float(a.pop("momentum", 0.0))
        centered = bool(a.pop("centered", False))
        opt = torch.optim.RMSprop(params, lr=lr, alpha=alpha, eps=eps, momentum=momentum,
                                  centered=centered, weight_decay=wd)
        desc = f"RMSprop(lr={lr:g}, alpha={alpha:g}, momentum={momentum:g})"
    else:
        raise ValueError(f"unknown optimizer type {name!r} (supported: Adam, AdamW, SGD, RMSprop)")
    if a:
        raise ValueError(f"unknown {name} args: {sorted(a)}")
    if grad_clip is not None:
        grad_clip = float(grad_clip)
        desc += f" + clip_grad_norm_({grad_clip:g})"
    scheduler, sched_desc = build_schedule(opt, scheduler_cfg)
    return opt, scheduler, grad_clip, f"{desc} | {sched_desc}"
