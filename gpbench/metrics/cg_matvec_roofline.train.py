"""Roofline share of the fused CG matvec (``csrc/gram_matvec.cu``) in the
traced steps: every launch of its main pass (``gram_matvec_sweep_kernel``)
the trace holds counts as one whole matvec (K + σ²I)·[y, Z], at the least
time of its operations (``counts.matvec_flops``) or of its bytes, x and the
N × (1 + p) block read and the product written once, 4·(N·D + 2·N·(1 + p)),
whichever is longer; over the device time of those launches and of their
in-order sums (``gram_matvec_reduce_kernel``), %. None where the trace holds
no such launch (a program whose matvec is the panel loop)."""

from gpbench.metrics import _shared


def read(rec):
    tr = rec["trace"]
    launches = [] if tr is None else tr.kernels("gram_matvec_sweep")
    if not launches:
        return None
    cfg = rec["config"]
    n, d, p = cfg["n"], cfg["d"], cfg["cg"]["num_probes"]
    cost = (4.0 * (n * d + 2.0 * n * (1 + p)), rec["counts"].matvec_flops(cfg))
    return _shared.roofline_percent(launches, [cost] * len(launches),
                                    tr.kernels("gram_matvec_reduce"))
