#!/usr/bin/env python3
"""Time the port's nine kernels (K1-K9) of two checkouts on one card, in
turns.

    python scripts/ab_kernels.py ROOT_A ROOT_B

ROOT_A and ROOT_B are repository roots (e.g. an unpacked ``git archive`` of
the parent commit, and ``.``).  Each turn is a process of its own that
imports ``lameness_tpu_torch`` from its root, builds that root's kernels,
and prints, per kernel, the bf16 device time per call at the shapes the
full-width engine gives it for B = 2 clips: torch.profiler's summed time of
the port's kernels only (``lameness::``; anything else an entry runs, such
as the augmented operands that a tree's K8 and K9 still build in HBM, left
out), over 20 calls (K1, K2, K7-K9) or 5 (K3-K6).  For K8 and K9 it also
prints the whole entry's device time (every kernel and copy the call puts
on the card), so that an operand build shows, and for K1 (``CALL_TIMED``)
the CUDA-event time per call over 200 calls back to back: the host's
launch rate, where that is longer than the kernel.  The turns run in the
order A B B A, so that a drift of the card between the first and the last turn
shows as a difference between the two A rows.  The card's name and power
limit come first; after the turns, whether each kernel's output in the B
turns equals the A turns' bit for bit (same seeded inputs), and for the
kernels of ``DIFF_PRINTED`` the largest |B - A| of their outputs as well
(K1, whose routine may differ between the trees in the order of its sums;
each turn saves its output under ``lameness_tpu_torch/_build/ab_kernels/``
of this script's checkout).
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

# the kernels whose whole entry is timed beside the kernel
ENTRY_TIMED = ("K8", "K9")
# the kernels whose calls are also timed by CUDA events, back to back: the
# host's rate of launching them (ctypes, the C entry's set-up) where it is
# longer than the kernel
CALL_TIMED = ("K1",)
# the kernels whose outputs are held against the A turns' by max |B - A|
DIFF_PRINTED = ("K1",)
SAVED = Path(__file__).resolve().parents[1] / "lameness_tpu_torch" / \
    "_build" / "ab_kernels"


def worker(root: str, saved: str) -> None:
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lameness_tpu_torch.ops import _cuda
    from lameness_tpu_torch.ops import attention as at
    from lameness_tpu_torch.ops import sam_attention as sa
    _cuda.build()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std
                ).to(torch.bfloat16)
    q, k, v = (rnd(10, 257, 12, 64).transpose(1, 2) for _ in range(3))
    calls = {"K1": (lambda: at.flash_attention(q, k, v), 20)}
    q4, k4, v4 = rnd(550, 196, 3, 12, 64).unbind(2)
    rh4, rw4 = sa.project_rel_tables_hl(q4, rnd(27, 64, std=0.1),
                                        rnd(27, 64, std=0.1), 14)
    calls["K2"] = (lambda: sa.sam_window_attention_v3(q4, k4, v4, rh4, rw4),
                   20)
    # K7 on the head-major views of the same qkv output, and the tables as
    # project_rel_tables gives them to the engine's head-major route
    q7, k7, v7 = (t.transpose(1, 2) for t in (q4, k4, v4))
    rh7, rw7 = (t.reshape(550, 12, 196, 14) for t in sa.project_rel_tables(
        q7.reshape(-1, 196, 64), rnd(27, 64, std=0.1), rnd(27, 64, std=0.1),
        14))
    calls["K7"] = (lambda: sa.sam_window_attention_v1(q7, k7, v7, rh7, rw7),
                   20)
    # K8 on K7's operands, K9 on K2's: the engine's v2 and v5 selections
    calls["K8"] = (lambda: sa.sam_window_attention_v2(q7, k7, v7, rh7, rw7),
                   20)
    calls["K9"] = (lambda: sa.sam_window_attention_v5(q4, k4, v4, rh4, rw4),
                   20)
    qg, kg, vg = (rnd(264, 4096, 64) for _ in range(3))
    rh, rw = sa.project_rel_tables(qg, rnd(127, 64, std=0.1),
                                   rnd(127, 64, std=0.1), 64)
    calls["K3"] = (lambda: sa.sam_global_attention(qg, kg, vg, rh, rw), 5)
    calls["K4"] = (lambda: sa.sam_global_attention_v1(qg, kg, vg, rh, rw), 5)
    calls["K5"] = (lambda: sa.sam_global_attention_v2(qg, kg, vg, rh, rw), 5)
    # K6 on head-last views of one (22, 4096, 3, 12, 64) qkv output
    q6, k6, v6 = rnd(22, 4096, 3, 12, 64).unbind(2)
    rh6, rw6 = sa.project_rel_tables_hl(q6, rnd(127, 64, std=0.1),
                                        rnd(127, 64, std=0.1), 64)
    calls["K6"] = (lambda: sa.sam_global_attention_v3(q6, k6, v6, rh6, rw6),
                   5)

    def device_ms(fn, reps, only):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and only in e.key)
        return us / reps / 1e3
    def call_ms(fn, reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    times, entry, call, sha = {}, {}, {}, {}
    for kid, (fn, reps) in calls.items():
        out = fn()
        torch.cuda.synchronize()
        sha[kid] = hashlib.sha1(out.contiguous().view(torch.int16).cpu()
                                .numpy().tobytes()).hexdigest()[:12]
        if kid in DIFF_PRINTED:
            torch.save(out.float().cpu(), f"{saved}-{kid}.pt")
        del out
        times[kid] = device_ms(fn, reps, "lameness::")
        if kid in ENTRY_TIMED:
            entry[kid] = device_ms(fn, reps, "")
        if kid in CALL_TIMED:
            call[kid] = call_ms(fn, 200)
    print(json.dumps({"ms": times, "entry_ms": entry, "call_ms": call,
                      "sha": sha}), flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], sys.argv[3])
        return 0
    roots = {"A": sys.argv[1], "B": sys.argv[2]}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    sha = {}
    SAVED.mkdir(parents=True, exist_ok=True)
    for i, turn in enumerate("ABBA"):
        res = subprocess.run([sys.executable, __file__, "--worker",
                              roots[turn], str(SAVED / f"{i}{turn}")],
                             capture_output=True, text=True)
        if res.returncode:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        sha.setdefault(turn, []).append(rec["sha"])
        print(f"{turn} {roots[turn]:24s} " + "  ".join(
            f"{kid} {ms:.4f} ms" for kid, ms in rec["ms"].items()) + "  "
            + "  ".join(f"{kid} entry {ms:.4f} ms"
                        for kid, ms in rec["entry_ms"].items()) + "  "
            + "  ".join(f"{kid} call {ms:.4f} ms"
                        for kid, ms in rec["call_ms"].items()), flush=True)
    same = {kid: all(s[kid] == sha["A"][0][kid] for s in sha["A"] + sha["B"])
            for kid in sha["A"][0]}
    print("outputs of B bit for bit equal to A's: " + json.dumps(same),
          flush=True)
    import torch
    for kid in DIFF_PRINTED:
        outs = [torch.load(SAVED / f"{i}{turn}-{kid}.pt")
                for i, turn in enumerate("ABBA")]
        diff = max(float((outs[i] - outs[0]).abs().max()) for i in (1, 2))
        print(f"{kid} max |B - A| {diff:.3e} (the A turns equal: "
              f"{torch.equal(outs[0], outs[3])}, the B turns equal: "
              f"{torch.equal(outs[1], outs[2])})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
