"""The control's lower precision: fp8 (e4m3) where the configuration
states bfloat16.

While a hooked module runs, every matrix product and convolution takes its
operands rounded to float8_e4m3fn, each tensor scaled by its own absolute
maximum (448 at the top of the format), and computes in f32: what an fp8
path with f32 accumulation would give. :func:`euler_solve_fp8` is the
sampler with its state held in fp8 as the program holds it in bf16: the
noise and each step's update rounded to fp8.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    if not (isinstance(x, torch.Tensor) and x.is_floating_point() and x.dim() >= 2):
        return x
    xf = x.float()
    s = xf.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return ((xf / s).to(torch.float8_e4m3fn).float() * s).to(x.dtype)


_PRODUCTS = {F.linear, F.conv1d, F.conv2d, F.conv_transpose1d, torch.matmul, torch.bmm,
             torch.mm, torch.einsum, torch.Tensor.matmul, torch.Tensor.__matmul__}


class FP8Products(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            if func is torch.einsum:
                args = (args[0], *[fake_fp8(a) for a in args[1:]])
            else:
                args = tuple(fake_fp8(a) for a in args)
        return func(*args, **kwargs)


def fp8(*modules) -> list:
    """Hooks that run each module's forward under :class:`FP8Products`;
    remove them to go back."""
    handles = []
    for m in modules:
        state = {}

        def pre(mod, inp, state=state):
            state["mode"] = FP8Products()
            state["mode"].__enter__()

        def post(mod, inp, out, state=state):
            state.pop("mode").__exit__(None, None, None)

        handles += [m.register_forward_pre_hook(pre), m.register_forward_hook(post)]
    return handles


def euler_solve_fp8(estimate_fn, noise, mu, x_lens, prompt, prompt_len, style,
                    n_timesteps, cfg_rate=0.7, precompute_fn=None, **_):
    """The frozen reference's Euler CFG sampler (linear schedule, no
    sharding) with its state rounded to fp8 where the program's is bf16."""
    T = mu.shape[1]
    t_span = torch.linspace(0.0, 1.0, n_timesteps + 1)
    noise = fake_fp8(noise)
    in_prompt = (torch.arange(T, device=mu.device) < prompt_len)[None, :, None]
    prompt_x = torch.where(in_prompt, prompt, torch.zeros_like(prompt))
    x = torch.where(in_prompt, torch.zeros_like(noise), noise)
    use_cfg = cfg_rate > 0
    if use_cfg:
        est = (torch.cat([prompt_x, torch.zeros_like(prompt_x)], 0),
               None if x_lens is None else torch.cat([x_lens, x_lens], 0),
               torch.cat([style, torch.zeros_like(style)], 0),
               torch.cat([mu, torch.zeros_like(mu)], 0))
    else:
        est = (prompt_x, x_lens, style, mu)
    est_prompt, est_lens, est_style, est_mu = est
    est_args = ()
    if precompute_fn is not None:
        shape = (est_mu.shape[0], T, noise.shape[-1])
        est_args = (precompute_fn(torch.zeros(shape, dtype=mu.dtype, device=mu.device),
                                  est_prompt, est_lens, est_style, est_mu),)
    for i in range(n_timesteps):
        t_cur = float(t_span[i])
        dt = float(t_span[i + 1] - t_span[i])
        xx = torch.cat([x, x], 0) if use_cfg else x
        t_vec = torch.full((xx.shape[0],), t_cur, device=x.device, dtype=mu.dtype)
        v = estimate_fn(xx, est_prompt, est_lens, t_vec, est_style, est_mu, *est_args)
        if use_cfg:
            v_cond, v_null = v.chunk(2, dim=0)
            v = (1.0 + cfg_rate) * v_cond - cfg_rate * v_null
        x = fake_fp8(x.float() + dt * v.float())
        x = torch.where(in_prompt, torch.zeros_like(x), x)
    return x
