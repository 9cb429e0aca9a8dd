#!/usr/bin/env python3
"""End-to-end decode benchmark on a real stream: native C++ front-end +
selected reconstruction backend. Prints per-stage timings and fps. The
device backend needs a GPU: it fails when JAX finds none.

Usage: python tools/bench_e2e.py stream.bin [numpy|device] [iters]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from libde265_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    path = sys.argv[1]
    backend = sys.argv[2] if len(sys.argv) > 2 else "device"
    iters = int(sys.argv[3]) if len(sys.argv) > 3 else 3
    if backend == "device":
        import jax
        if jax.default_backend() != "gpu":
            sys.exit(f"the device backend needs a GPU; JAX backend is "
                     f"{jax.default_backend()!r}")
    data = open(path, "rb").read()
    from libde265_tpu.api import decode_stream_native
    # warmup (compiles cached)
    pics = decode_stream_native(data, backend=backend)
    n = len(pics)
    t0 = time.time()
    for _ in range(iters):
        pics = decode_stream_native(data, backend=backend)
    dt = (time.time() - t0) / iters
    print(f"{os.path.basename(path)}: {n} frames, backend={backend}: "
          f"{dt:.3f} s/stream = {n / dt:.2f} fps "
          f"({pics[0].width}x{pics[0].height})")


if __name__ == "__main__":
    sys.exit(main())
