"""Device time per jitted program, and the device's idle share, from a
jax.profiler trace (the `*.xplane.pb` that `chip_smoke.py --trace DIR`
writes).

    python tools/trace_summary.py DIR

For each GPU plane: the window (first to last kernel), busy time (the
union of the kernel intervals), idle share (1 - busy / window), and the
kernel time of each XLA module (one per jitted program, from each
kernel's `hlo_module` stat) with its share of busy time.  Copies and
fills (any event whose name holds "memcpy" or "memset", in any case:
the runtime's `MemcpyD2H` and XLA's `memcpy32_post` kernels alike) are
left out of all three and reported on their own line.  Kernel times
are summed, so overlapping kernels count twice.
Reads the trace with nothing but JAX.
"""

import glob
import os
import re
import sys

_COPY = re.compile("memcpy|memset", re.IGNORECASE)


def _union_ns(spans):
    busy, end = 0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def _stat(event, names):
    for k, v in event.stats:
        if k in names:
            return v
    return None


def summarize(path: str) -> None:
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = {ln.name: list(ln.events) for ln in plane.lines}
        print(f"{plane.name}: lines " + ", ".join(
            f"{n!r} ({len(ev)})" for n, ev in lines.items()))
        events = [e for n, ev in lines.items() if n != "XLA Modules"
                  for e in ev]
        copies = [e for e in events if _COPY.search(e.name)]
        kernels = [e for e in events if not _COPY.search(e.name)]
        spans = [(e.start_ns, e.start_ns + e.duration_ns) for e in kernels]
        if not spans:
            continue
        if kernels:
            print("  stats of one event: " + ", ".join(
                f"{k}={str(v)[:60]}" for k, v in kernels[0].stats))
        window = max(e for _, e in spans) - min(s for s, _ in spans)
        busy = _union_ns(spans)
        print(f"  window {window / 1e6:.3f} ms, busy {busy / 1e6:.3f} ms, "
              f"idle share {1 - busy / window:.4f} (copies excluded)")
        print(f"  copies and fills: {len(copies)} events, "
              f"{sum(e.duration_ns for e in copies) / 1e6:.3f} ms")
        # device time per program: the module each kernel belongs to
        mods = {}
        for e in kernels:
            name = _stat(e, ("hlo_module", "hlo_module_name")) or "?"
            name = re.sub(r"\(\d+\)$", "", str(name))
            n, t = mods.get(name, (0, 0))
            mods[name] = (n + 1, t + e.duration_ns)
        for name, (n, t) in sorted(mods.items(), key=lambda kv: -kv[1][1]):
            print(f"  {t / 1e6:10.3f} ms  {t / busy:7.2%} of busy  "
                  f"{n:7d} kernels  {name}")
        ops = {}
        for e in kernels:
            n, t = ops.get(e.name, (0, 0))
            ops[e.name] = (n + 1, t + e.duration_ns)
        print("  top kernels:")
        for name, (n, t) in sorted(ops.items(), key=lambda kv: -kv[1][1])[:15]:
            print(f"  {t / 1e6:10.3f} ms  {t / busy:7.2%} of busy  "
                  f"{n:7d} x  {name[:70]}")


def main(argv) -> int:
    paths = sorted(glob.glob(os.path.join(argv[0], "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        print(f"no *.xplane.pb under {argv[0]}", file=sys.stderr)
        return 1
    summarize(paths[-1])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
