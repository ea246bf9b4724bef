"""Operations of the temporal GP's work (σ²·Matérn-3/2 on N sorted
timestamps, state dimension 2), from its shapes.

Model FLOPs are those of the sequential Kalman filter's log-likelihood and
of its reverse-mode gradient, whatever implements them: the parallel
scan's extra combines, and the chunks' carries, are not counted, and a
later PR that filters another way keeps the same count. A step of the
filter, one timestamp (x = λΔt, u = 2x; the constants λ, λ², σ² once a
call):
  the transition A = e^{−x}[[1 + x, Δt], [−λx, 1 − x]]: x, e^{−x}, the
  four entries and their scaling                                     9
  the process noise Q₁₁, Q₁₂, Q₂₂ in closed form: u, e^{−u}, u², and
  the three entries                                                 20
  the prediction m⁻ = A m (4 products, 2 sums) and P⁻ = A P Aᵀ + Q
  (A P 12, its product with Aᵀ over the symmetric triangle 9, + Q 3)  30
  the update: v = y − m⁻₁, S = P⁻₁₁ + R, K = P⁻₁/S (2), m⁻ + K v (4),
  P⁻ − K P⁻₁ᵀ over the triangle (6)                                 14
  the term −½(log S + v²/S) and its sum                               6
                                                                  = 79
The gradient by reverse mode costs two operations of the adjoint for
each of the forward (c = a·b gives ā += c̄·b and b̄ += c̄·a), so a
step of MLE-II is 3 · 79 · N: 2.37e8 at N = 10⁶, about 3.5 µs of the
card's FP32 peak. The kernels run no port kernel, so no roofline.
"""

from __future__ import annotations

FILTER_STEP_FLOPS = 9 + 20 + 30 + 14 + 6   # a timestamp's forward work
ADJOINT_FACTOR = 2                         # reverse mode, a forward operation's


def step_flops(cfg: dict, traffic: dict) -> float:
    return (1 + ADJOINT_FACTOR) * FILTER_STEP_FLOPS * float(cfg["n"])
