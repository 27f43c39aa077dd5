#!/usr/bin/env python3
"""Build kernel 5's backward alone, print ptxas' report for it, and hold
it against its plain version and an f64 autograd witness at its tile
edges and at phase 2h's training shapes, f32 and bf16, on one card.

    python3 tools/check_bwd.py

For each case it prints one line: ok or BAD; each gradient's largest
difference from the plain version against ``chip_smoke.grad_limit``; in
f32 (where the witness fits) the kernel's and the plain version's
distances from ``chip_smoke.f64_grads`` (the kernel may be at most twice
as far); two calls bitwise equal; rows no query or key reaches summed
(must be 0); one tensor-core launch a call; ms a call by CUDA events
(``chip_smoke.cuda_ms``) beside the library's backward
(``chip_smoke.sdpa_bwd_ms``), and at the larger shapes each launch's
device ms by the profiler.  Exits non-zero without a card or if a case
fails.
"""
import sys
import time

import torch

sys.path.insert(0, "src")
sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels.chunked_prefill_attention import (  # noqa: E402
    chunked_prefill_attention, chunked_prefill_attention_bwd)

if not torch.cuda.is_available():
    print("check_bwd: no CUDA card", file=sys.stderr)
    sys.exit(2)

t0 = time.time()
rep = build.build(["chunked_prefill_attention_bwd"])
print(f"build {time.time() - t0:.1f} s")
for line in rep.get("chunked_prefill_attention_bwd", "").splitlines():
    if ("registers" in line or "spill" in line or "error" in line
            or "warning" in line or "Compiling" in line):
        print(line.strip()[:200])
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(7)
# (what, (h, kvh, hd, hd_v), window, causal, b, sq, q_off, skv, kv_len):
# the GPU tests' shapes and tile edges, then phase 2h's
cases = [
    ("opt small", (12, 12, 64, 64), 0, True, 4, 96, 0, 96, [96] * 4),
    ("100m offset ragged", (12, 4, 64, 64), 0, True, 3, 70, 60, 150,
     [130, 0, 100]),
    ("rg windowed", (16, 1, 256, 256), 40, True, 1, 150, 0, 150, [150]),
    ("mla", (8, 8, 192, 128), 0, True, 1, 80, 0, 80, [80]),
    ("cross", (32, 8, 128, 128), 0, False, 2, 100, 0, 45, [45, 45]),
    ("hd32", (4, 4, 32, 32), 0, True, 2, 33, 0, 33, [33, 33]),
    ("smoke mla", (4, 4, 80, 64), 0, True, 2, 33, 0, 33, [33, 33]),
    ("sq 65", (12, 12, 64, 64), 0, True, 2, 65, 0, 65, [65, 65]),
    ("sq 127 kv mid", (12, 4, 64, 64), 0, True, 2, 127, 0, 127, [127, 90]),
    ("qwen rep 7", (14, 2, 64, 64), 0, True, 2, 200, 0, 200, [200, 131]),
    ("window mid", (8, 2, 128, 128), 37, True, 2, 190, 0, 190, [190, 170]),
    ("3s", (12, 12, 64, 64), 0, True, 64, 256, 0, 256, [256] * 64),
    ("100m 4096", (12, 4, 64, 64), 0, True, 2, 4096, 0, 4096, [4096] * 2),
    ("rg 4096", (16, 1, 256, 256), 2048, True, 1, 4096, 0, 4096, [4096]),
    ("mla 1024", (128, 128, 192, 128), 0, True, 1, 1024, 0, 1024, [1024]),
    ("cross 512", (32, 8, 128, 128), 0, False, 2, 512, 0, 1600,
     [1600, 1000]),
]
bad = 0
for what, widths, window, causal, *shape in cases:
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, kv_len, q_off = cs.dense_case(widths, *shape, dtype, dev,
                                               gen)
        kw = dict(window=window, causal=causal)
        if dtype == torch.bfloat16 and widths[2] == 80:
            # kernel 5 has no bf16 body at (80, 64)
            out = ref.chunked_prefill_attention(q, k, v, kv_len, q_off,
                                                **kw).contiguous()
        else:
            out = chunked_prefill_attention(q, k, v, kv_len, q_off, **kw)
        dout = torch.randn(out.shape, generator=gen, device=dev).to(dtype)
        args = (q, k, v, out, dout, kv_len, q_off)
        n0 = (chunked_prefill_attention_bwd.launches,
              chunked_prefill_attention_bwd.tensor_core_launches)
        try:
            got = chunked_prefill_attention_bwd(*args, **kw)
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001
            print(f"FAIL {what} {dtype}: {e}")
            bad += 1
            continue
        n1 = (chunked_prefill_attention_bwd.launches,
              chunked_prefill_attention_bwd.tensor_core_launches)
        again = chunked_prefill_attention_bwd(*args, **kw)
        same = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
        exp = ref.chunked_prefill_attention_bwd(*args, **kw)
        msg = []
        ok = same and n1[0] - n0[0] == 1 and n1[1] - n0[1] == 1
        for g, e, lab in zip(got, exp, ("dq", "dk", "dv")):
            err = float((g.float() - e.float()).abs().max())
            lim = cs.grad_limit(e)
            fin = bool(torch.isfinite(g).all())
            ok &= fin and err <= lim
            msg.append(f"{lab} {err:.2e}/{lim:.1e}")
        live = cs.live_keys(q, kv_len, q_off, k.shape[1], window, causal)
        dq_, dk_ = ~live.any(2), ~live.any(1)
        zeros = (float(got[0][dq_].float().abs().sum())
                 + float(got[1][dk_].float().abs().sum())
                 + float(got[2][dk_].float().abs().sum()))
        ok &= zeros == 0.0
        if dtype == torch.float32 and q.shape[1] * q.shape[2] <= 65536:
            ex = cs.f64_grads(q, k, v, kv_len, q_off, dout, window, causal)
            for g, e, x, lab in zip(got, exp, ex, ("dq", "dk", "dv")):
                k64 = float((g.double() - x).abs().max())
                p64 = float((e.double() - x).abs().max())
                ok &= k64 <= max(2 * p64, 2e-5)
                msg.append(f"f64 {lab} {k64:.2e}/{p64:.2e}")
        line = (f"{'ok ' if ok else 'BAD'} {what} {str(dtype)[6:]}: "
                + ", ".join(msg) + f"; det {same}; zeros {zeros}")

        def call(a=args, kw=kw):
            return chunked_prefill_attention_bwd(*a, **kw)
        ms = cs.cuda_ms(call)
        lib = cs.sdpa_bwd_ms(q, k, v, kv_len, q_off, dout, window,
                             causal)
        _, fl = cs.bwd_work(q, k, v, kv_len, q_off, window, causal)
        line += (f"; {ms:.4f} ms ({fl / ms / 1e9:.1f} TFLOP/s), "
                 f"sdpa bwd {lib:.4f} ms")
        if q.shape[0] * q.shape[1] >= 4096:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    call()
                torch.cuda.synchronize()
            for ev in prof.key_averages():
                for kn in ("dq_kernel", "dkdv_kernel"):
                    if kn in ev.key:
                        t = getattr(ev, "device_time_total", None)
                        if t is None:
                            t = ev.cuda_time_total
                        line += f"; {kn} {t / ev.count / 1e3:.4f} ms"
        print(line, flush=True)
        bad += not ok
        del args, q, k, v, out, dout, got, again, exp
        torch.cuda.empty_cache()
print("probe", "FAILED" if bad else "passed", bad, cs.card_line())
sys.exit(1 if bad else 0)
