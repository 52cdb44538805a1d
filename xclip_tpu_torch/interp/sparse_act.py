"""SparseAct: a vector in a dictionary (SAE feature) basis plus the error term.

Counterpart of ``xclip_tpu/interp/sparse_act.py`` (the reference's
``activation_utils.py:8-186``): an ``(act, res | resc)`` triple of tensors
with elementwise operators; ``@`` multiplies the ``act`` parts elementwise
and contracts the ``res`` parts into ``resc``. A plain class: PyTorch needs
no pytree registration to differentiate through it.
"""

from __future__ import annotations

import torch


class SparseAct:
    def __init__(self, act=None, res=None, resc=None):
        self.act = act
        self.res = res
        self.resc = resc

    def _map(self, f, aux=None) -> "SparseAct":
        kwargs = {}
        for attr in ("act", "res", "resc"):
            mine = getattr(self, attr)
            if mine is None:
                continue
            if isinstance(aux, SparseAct):
                other = getattr(aux, attr)
                if other is None:
                    continue
                kwargs[attr] = f(mine, other)
            else:
                kwargs[attr] = f(mine, aux)
        return SparseAct(**kwargs)

    def __mul__(self, other):
        return self._map(lambda x, y: x * y, other)

    __rmul__ = __mul__

    def __add__(self, other):
        return self._map(lambda x, y: x + y, other)

    __radd__ = __add__

    def __sub__(self, other):
        return self._map(lambda x, y: x - y, other)

    def __truediv__(self, other):
        return self._map(lambda x, y: x / y, other)

    def __neg__(self):
        return self._map(lambda x, _: -x)

    def __matmul__(self, other: "SparseAct") -> "SparseAct":
        """Elementwise on act, contraction on res (reference :46-49)."""
        assert self.res is not None and other.res is not None
        return SparseAct(act=self.act * other.act,
                         resc=torch.sum(self.res * other.res, dim=-1, keepdim=True))

    def __getitem__(self, index):
        return self.act[index]

    def sum(self, axis=None):
        return self._map(lambda x, _: x.sum() if axis is None else x.sum(dim=axis))

    def mean(self, axis=None):
        return self._map(lambda x, _: x.mean() if axis is None else x.mean(dim=axis))

    def abs(self):
        return self._map(lambda x, _: x.abs())

    def detach(self):
        return self._map(lambda x, _: x.detach())

    def zeros_like(self):
        return self._map(lambda x, _: torch.zeros_like(x))

    def ones_like(self):
        return self._map(lambda x, _: torch.ones_like(x))

    def to_tensor(self):
        if self.resc is None:
            assert self.res is not None
            return torch.cat([self.act, self.res], dim=-1)
        assert self.res is None
        return torch.cat([self.act, self.resc], dim=-1)

    def __repr__(self):
        return f"SparseAct(act={self.act!r}, res={self.res!r}, resc={self.resc!r})"
