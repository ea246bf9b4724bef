"""The precision a plain reference computes in, and emulated TF32.

``Prec("float64")`` is the reference. ``Prec("tf32")`` is the control: the
same arithmetic in float32 with every matrix product that the reference
takes through ``Prec.mm`` (the gram's cross term, the predictive mean,
CᵀA) taken as TF32 tensor cores take it, each operand rounded to a 10-bit
mantissa and the products summed in float32. The Cholesky factor and the
triangular solves stay in IEEE float32, so the control is only partly
TF32 and reads lower than a whole TF32 run would. It is emulated, so the
control reads the same on the CPU and on the card.
"""

from __future__ import annotations

import dataclasses

import torch


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """Round a float32 tensor to TF32 (10 explicit mantissa bits, to
    nearest, ties away from zero)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Prec:
    name: str  # "float64" or "tf32"

    @property
    def dtype(self) -> torch.dtype:
        return torch.float64 if self.name == "float64" else torch.float32

    def cast(self, t: torch.Tensor) -> torch.Tensor:
        return t.detach().to(self.dtype)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` in this precision (IEEE float32 where not TF32)."""
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            if self.name == "tf32":
                return to_tf32(a) @ to_tf32(b)
            return a @ b
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev


F64 = Prec("float64")
TF32 = Prec("tf32")
