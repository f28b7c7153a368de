"""Work counts: the operations and bytes each kernel launch needs, from
its shapes, and the model FLOPs of a reference run.

The formulas are those the port's kernel table uses (PERF.md): attention
4 B H Sq Sk D operations forward (Sk the live keys), 10 B H S^2 D
backward; the (3,1,1) temporal conv 2 M 3 C Cout; each input read once
and each output written once, bf16 activations (2 bytes), fp32
statistics and coefficients (4 bytes)."""

from __future__ import annotations

from contextlib import contextmanager


def flash_fwd_work(b, heads, sq, sk, d, lse=False):
    """K1 (and K2 `with_l`): q/k/v/o bf16 [B, S, H*D], live keys sk."""
    flops = 4.0 * b * heads * sq * sk * d
    nbytes = 2.0 * b * heads * d * (2 * sq + 2 * sk) + (
        4.0 * b * heads * sq if lse else 0.0)
    return flops, nbytes


def flash_bwd_work(b, heads, sq, sk, d):
    """K3: reads q, k, v, o, dO (bf16) and the lse (fp32); writes dQ,
    dK, dV (bf16)."""
    flops = 10.0 * b * heads * sq * sk * d
    nbytes = 2.0 * b * heads * d * (3 * sq + 2 * sk + 2 * sk + sq) \
        + 4.0 * b * heads * sq
    return flops, nbytes


def tconv3_work(b, f, n, c, cout, residual, want_stats, per_frame):
    """K5: x [B, F, N, C] in, the GN coefficients (a, b) [B, C] fp32,
    weights [3, C, Cout] bf16, bias fp32, the output (and residual)
    [B, F, N, Cout], the output statistics fp32."""
    m = b * f * n
    flops = 2.0 * m * 3 * c * cout
    nbytes = (2.0 * (m * c + m * cout * (2 if residual else 1)
                     + 3 * c * cout)
              + 4.0 * (2 * b * c + cout))
    if want_stats:
        nbytes += 4.0 * 2 * (b * f if per_frame else b) * cout
    return flops, nbytes


def qk_ln_rope_bwd_work(rows, s, c):
    """K9's backward: reads x and dy (bf16 [rows, C]) and the [S, 64]
    fp32 cos/sin tables, writes dx (bf16)."""
    return 0.0, 2.0 * 3 * rows * c + 4.0 * 2 * s * 64


class LaunchLog:
    """Shapes of the kernel launches the program makes while it is
    recorded: the launchers of ops/flash_attention.py (K1, K2, K3),
    ops/fused_temporal_conv.py (K5) and ops/qk_ln_rope.py (K9) are
    wrapped, the arguments noted, the launcher called as before; K9's
    backward calls are read from its counter."""

    def __init__(self):
        self.flash: list[tuple] = []     # (B, heads, Sq, Sk_live, D, lse)
        self.flash_bwd: list[tuple] = []  # flash_bwd_work's arguments
        self.tconv3: list[tuple] = []    # tconv3_work's arguments
        self.qk: list[tuple] = []        # K9 forward: (rows, S, C)
        self.qk_backwards = 0            # K9 backward calls (its counter)

    @contextmanager
    def recording(self):
        from star_tpu_torch.ops import flash_attention as fa
        from star_tpu_torch.ops import fused_temporal_conv as ftc
        from star_tpu_torch.ops import qk_ln_rope as qk
        real_fa, real_tc = fa._launch, ftc._launch
        real_bwd, real_qk = fa._launch_bwd, qk._launch
        backwards0 = qk.BACKWARDS

        def bwd_launch(q, k, v, o, lse, do, heads, scale, kv_valid):
            self.flash_bwd.append((q.shape[0], heads, q.shape[1],
                                   min(kv_valid, k.shape[1]),
                                   q.shape[-1] // heads))
            return real_bwd(q, k, v, o, lse, do, heads, scale, kv_valid)

        def qk_launch(x, *a):
            self.qk.append((x.shape[0] * x.shape[1], x.shape[1],
                            x.shape[2]))
            return real_qk(x, *a)

        def fa_launch(q, k, v, heads, d, c, kv_valid, want_lse=False):
            self.flash.append((q.shape[0], heads, q.shape[1],
                               min(kv_valid, k.shape[1]), d, want_lse))
            return real_fa(q, k, v, heads, d, c, kv_valid, want_lse)

        def tc_launch(x, a, b, kernel3, bias, residual, want_stats,
                      per_frame):
            bsz, f, n, c = x.shape
            self.tconv3.append((bsz, f, n, c, kernel3.shape[-1],
                                residual is not None, bool(want_stats),
                                bool(per_frame)))
            return real_tc(x, a, b, kernel3, bias, residual, want_stats,
                           per_frame)

        fa._launch, ftc._launch = fa_launch, tc_launch
        fa._launch_bwd, qk._launch = bwd_launch, qk_launch
        try:
            yield self
        finally:
            fa._launch, ftc._launch = real_fa, real_tc
            fa._launch_bwd, qk._launch = real_bwd, real_qk
            self.qk_backwards = qk.BACKWARDS - backwards0


class FlopCount:
    """Model FLOPs of what runs inside (torch.utils.flop_counter: matrix
    products and convolutions), in `flops` once it has closed."""

    def __enter__(self):
        from torch.utils.flop_counter import FlopCounterMode
        self.mode = FlopCounterMode(display=False)
        self.mode.__enter__()
        self.flops = None
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)
        self.flops = float(self.mode.get_total_flops())
        return False
