"""Gather-free small-table lookups.

Every spec table in the decode path is tiny (<=64 entries: beta/tc
tables 54, chroma-QP 14, per-slice param rows), so an unrolled select
chain — S vectorized elementwise passes — replaces each gather over a
big index grid with pure elementwise work that XLA fuses into the
consumer.

Reference counterpart: plain C array indexing (deblock.cc tc/beta table
reads).
"""
import jax.numpy as jnp


def take_small(tab, idx):
    """tab: (S,) vector (static numpy or traced device array), small S.
    idx: any-shape int array with values in [0, S). Returns tab[idx]
    without emitting a gather: an unrolled select chain (out-of-range idx
    yields tab[S-1], matching callers that pre-clip)."""
    tab = jnp.asarray(tab)
    S = tab.shape[0]
    out = jnp.broadcast_to(tab[S - 1], idx.shape)
    for s in range(S - 1):
        out = jnp.where(idx == s, tab[s], out)
    return out


def take_rows_small(tab, idx):
    """tab: (S, ...) with small leading S; idx: (...) ints in [0, S).
    Returns tab[idx] of shape idx.shape + tab.shape[1:] as a select chain
    over rows (no gather)."""
    tab = jnp.asarray(tab)
    S = tab.shape[0]
    tail = tab.shape[1:]
    idx_e = idx.reshape(idx.shape + (1,) * len(tail))
    out = jnp.broadcast_to(tab[S - 1], idx.shape + tail)
    for s in range(S - 1):
        out = jnp.where(idx_e == s, tab[s], out)
    return out
