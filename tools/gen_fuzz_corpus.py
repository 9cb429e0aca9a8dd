#!/usr/bin/env python3
"""Generate the committed adversarial corpus:
deterministic bit-flip / truncation / duplication / garbage mutations of
small committed streams, written as tests/data/id_NNN_<kind>.bin — the
'id_' prefix marks AFL-style corpora for tools/decodestreams.py (allowed
to fail decode, must never crash; reference model:
/root/reference/scripts/decodestreams.py:46-74)."""
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")

SOURCES = ["intra_64x64_q27", "intra_104x72_q26", "lowdelay_cif_q28",
           "p_mv", "p_tiles22", "p_wppx", "p_pcm", "p_tskip", "b_mv",
           "p_slices2",
           # round-4 adversarial combo vectors: WPP x dep-slices,
           # tiles x lossless, LTR x TSA, rext x tiles — new syntax
           # interactions under mutation
           "adv_wpp_dep10_scaling", "adv_tiles_lossless",
           "adv_ltr_tsa_scaling", "adv_422_tiles_tskip",
           "adv_dep_pcm_strong",
           # round-5 syntax: rext residual tools (CCP, RDPCM, rotation,
           # persistent Rice, TU chroma QP offsets) + PCM in rext
           # chroma formats — mutations over the new parse paths
           "rxt_kitchen", "rxt_ccp_444", "rxt_erdpcm_rot_tsctx",
           "rxt_rice", "rxt_cqo", "adv_pcm_422", "adv_pcm_444"]


def main():
    rng = np.random.RandomState(48879)
    n = 0
    for src in SOURCES:
        path = os.path.join(DATA, src + ".bin")
        if not os.path.exists(path):
            continue
        data = bytearray(open(path, "rb").read())
        L = len(data)
        muts = []
        # bit flips at deterministic spread positions (skip the first 16
        # bytes so parameter sets sometimes survive -> deeper code paths)
        for k in range(3):
            d = bytearray(data)
            for pos in rng.randint(16, L, 5):
                d[pos] ^= 1 << rng.randint(0, 8)
            muts.append((f"flip{k}", bytes(d)))
        # truncations (mid-slice)
        for k, frac in enumerate((0.35, 0.8)):
            muts.append((f"trunc{k}", bytes(data[:int(L * frac)])))
        # duplicate a middle chunk (fake NAL boundary confusion)
        mid = L // 2
        muts.append(("dup", bytes(data[:mid] + data[mid // 2:mid] +
                                  data[mid:])))
        # random garbage injected after a valid prefix
        g = rng.randint(0, 256, 256).astype(np.uint8).tobytes()
        muts.append(("inject", bytes(data[:L // 3]) + g +
                     bytes(data[L // 3:])))
        for kind, blob in muts:
            fn = f"id_{n:03d}_{src}_{kind}.bin"
            with open(os.path.join(DATA, fn), "wb") as f:
                f.write(blob)
            n += 1
    print(f"wrote {n} fuzz corpus files to tests/data/")


if __name__ == "__main__":
    main()
