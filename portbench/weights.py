"""Seeded weights for a parameter spec (``reference/model.py::spec``), made
on the device in three large draws and sliced: one normal, one uniform,
the rest filled. The same seed gives the same tensors, so the program and
the reference are handed equal weights without either making them."""
import torch


def make(spec, seed, device):
    """{name: f32 tensor} for [(name, shape, init)], from ``seed``."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    sizes = {kind: sum(_numel(s) for _, s, init in spec if init[0] == kind)
             for kind in ("normal", "uniform")}
    normal = torch.randn(sizes["normal"], generator=g, device=device)
    uniform = torch.rand(sizes["uniform"], generator=g, device=device)
    at = {"normal": 0, "uniform": 0}
    out = {}
    for name, shape, init in spec:
        n = _numel(shape)
        kind = init[0]
        if kind == "normal":
            t = normal[at[kind]:at[kind] + n] * init[1]
        elif kind == "uniform":
            t = uniform[at[kind]:at[kind] + n] * (init[2] - init[1]) + init[1]
        elif kind == "ones":
            t = torch.ones(n, device=device)
        elif kind == "zeros":
            t = torch.zeros(n, device=device)
        else:
            raise ValueError(f"{name}: unknown init {init}")
        at[kind] = at.get(kind, 0) + n
        out[name] = t.reshape(shape).contiguous()
    return out


def _numel(shape):
    n = 1
    for d in shape:
        n *= d
    return n
