"""Binary bag-of-words place recognition as array operations.

Replaces DBoW2 (/root/reference/Thirdparty/DBoW2: ``TemplatedVocabulary``
k-ary tree, ``transform`` :1066-1127, L1 ``ScoringObject.cpp:23``) and the
``KeyFrameDatabase`` inverted file (/root/reference/src/KeyFrameDatabase.cc).

Design (SURVEY §7.1): the vocabulary is an array-encoded k-ary tree — node
descriptors ``uint32 (n_nodes, 8)``, children ``int32 (n_nodes, k)``;
``transform`` is a batched fixed-depth descent (one Hamming argmin per level
per keypoint). Image signatures are DENSE tf-idf vectors (n_words,): at
vocabulary sizes of 1e4 a dense (K, W) @ (W,) matvec replaces the
inverted-file gather, so the inverted file disappears entirely.

The reference's ORBvoc.txt (1e6 nodes, k=10 L=6) is absent from the mount
(SURVEY Appendix B); vocabularies are trained here by binary k-majority
k-means (``train_vocabulary``) on whatever corpus is available.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class Vocabulary(NamedTuple):
    node_desc: jnp.ndarray   # (n_nodes, 8) uint32
    children: jnp.ndarray    # (n_nodes, k) int32, -1 = none
    word_id: jnp.ndarray     # (n_nodes,) int32: leaf -> word index, else -1
    idf: jnp.ndarray         # (n_words,) float32
    k: int
    depth: int
    n_words: int


def _hamming(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(..., 8) x (..., 8) -> (...) int32 popcount distance."""
    a = jax.lax.bitcast_convert_type(a, jnp.int32)
    b = jax.lax.bitcast_convert_type(b, jnp.int32)
    return jax.lax.population_count(a ^ b).sum(-1)


# ---------------------------------------------------------------------------
# Training: binary k-means with bit-majority centroids
# ---------------------------------------------------------------------------

def _bit_majority(descs: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Weighted per-bit majority of (N, 8) uint32 -> (8,) uint32.

    (FORB::meanValue behaviour, Thirdparty/DBoW2/DBoW2/FORB.cpp.)
    """
    n = len(descs)
    acc = np.zeros(256, np.float64)
    chunk = 262144
    for i in range(0, n, chunk):
        bits = np.unpackbits(descs[i:i + chunk].view(np.uint8), axis=-1,
                             bitorder="little")          # (n', 256) uint8
        acc += bits.astype(np.float64).T @ weights[i:i + chunk]
    mean = acc / max(weights.sum(), 1e-9)
    out_bits = (mean > 0.5).astype(np.uint8)
    return np.packbits(out_bits, bitorder="little").view(np.uint32)


_POPCOUNT8 = np.unpackbits(
    np.arange(256, dtype=np.uint8)[:, None], axis=-1).sum(-1).astype(np.uint8)


def _np_hamming_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(Na, 8) x (Nb, 8) -> (Na, Nb) Hamming. Chunked over rows with a
    byte-popcount LUT so million-descriptor corpora (the 100k-word real
    vocabulary) train without materializing (Na, Nb, 256) bit tensors."""
    n = len(a)
    chunk = max(1, int(4e6 / max(len(b), 1)))
    if n <= chunk:
        x = (a[:, None, :] ^ b[None, :, :]).view(np.uint8)
        return _POPCOUNT8[x].sum(-1, dtype=np.int32)
    out = np.empty((n, len(b)), np.int32)
    for i in range(0, n, chunk):
        x = (a[i:i + chunk, None, :] ^ b[None, :, :]).view(np.uint8)
        out[i:i + chunk] = _POPCOUNT8[x].sum(-1, dtype=np.int32)
    return out


def _kmeans_binary(descs: np.ndarray, k: int, rng, iters: int = 8):
    """Binary k-means. Returns (centers (k', 8), assignment (N,))."""
    n = len(descs)
    k = min(k, n)
    sel = rng.choice(n, k, replace=False)
    centers = descs[sel].copy()
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        d = _np_hamming_matrix(descs, centers)
        assign = d.argmin(-1)
        new_centers = []
        for c in range(len(centers)):
            members = descs[assign == c]
            if len(members) == 0:
                continue
            new_centers.append(_bit_majority(members, np.ones(len(members))))
        centers = np.stack(new_centers)
        if len(centers) <= 1:
            break
    d = _np_hamming_matrix(descs, centers)
    assign = d.argmin(-1)
    return centers, assign


def train_vocabulary(descriptors: np.ndarray, k: int = 10, depth: int = 4,
                     seed: int = 0,
                     doc_ids: np.ndarray | None = None) -> Vocabulary:
    """Hierarchical binary k-means (TemplatedVocabulary::create behaviour).

    descriptors: (N, 8) uint32 training corpus. doc_ids: optional (N,) image
    ids for idf statistics (uniform idf if absent).
    """
    rng = np.random.default_rng(seed)
    node_desc = [np.zeros(8, np.uint32)]   # root placeholder
    children: list = [[]]
    word_of_node = {}

    def build(node_id, descs, level, ids):
        if level == depth or len(descs) < k:
            return
        centers, assign = _kmeans_binary(descs, k, rng)
        for c in range(len(centers)):
            cid = len(node_desc)
            node_desc.append(centers[c])
            children.append([])
            children[node_id].append(cid)
            sub = assign == c
            build(cid, descs[sub], level + 1,
                  ids[sub] if ids is not None else None)

    ids = doc_ids if doc_ids is not None else None
    build(0, descriptors, 0, ids)

    n_nodes = len(node_desc)
    child_arr = np.full((n_nodes, k), -1, np.int32)
    for i, ch in enumerate(children):
        child_arr[i, :len(ch)] = ch
    word_id = np.full(n_nodes, -1, np.int32)
    w = 0
    for i in range(n_nodes):
        if children[i] == [] and i != 0:
            word_id[i] = w
            w += 1
    n_words = w

    # idf from the training corpus.
    voc = Vocabulary(
        node_desc=jnp.asarray(np.stack(node_desc)),
        children=jnp.asarray(child_arr),
        word_id=jnp.asarray(word_id),
        idf=jnp.ones((max(n_words, 1),), jnp.float32),
        k=k, depth=depth, n_words=n_words)
    if doc_ids is not None and n_words > 0:
        words = np.asarray(transform(voc, jnp.asarray(descriptors),
                                     jnp.ones(len(descriptors), bool)))
        n_docs = int(doc_ids.max()) + 1
        df = np.zeros(n_words, np.float64)
        for d in range(n_docs):
            ws = np.unique(words[doc_ids == d])
            ws = ws[ws >= 0]
            df[ws] += 1
        idf = np.log(n_docs / np.maximum(df, 1.0))
        voc = voc._replace(idf=jnp.asarray(idf.astype(np.float32)))
    return voc


def save_vocabulary(path: str, voc: Vocabulary):
    np.savez_compressed(
        path, node_desc=np.asarray(voc.node_desc),
        children=np.asarray(voc.children), word_id=np.asarray(voc.word_id),
        idf=np.asarray(voc.idf),
        meta=np.array([voc.k, voc.depth, voc.n_words], np.int64))


def load_vocabulary(path: str) -> Vocabulary:
    z = np.load(path)
    k, depth, n_words = [int(x) for x in z["meta"]]
    return Vocabulary(node_desc=jnp.asarray(z["node_desc"]),
                      children=jnp.asarray(z["children"]),
                      word_id=jnp.asarray(z["word_id"]),
                      idf=jnp.asarray(z["idf"]),
                      k=k, depth=depth, n_words=n_words)


# ---------------------------------------------------------------------------
# Transform + scoring (jitted)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("depth",))
def _transform_impl(node_desc, children, word_id, desc, valid, depth: int):
    n = desc.shape[0]
    node = jnp.zeros((n,), jnp.int32)
    for _ in range(depth):
        ch = children[node]                       # (N, k)
        has_child = ch >= 0
        ch_safe = jnp.maximum(ch, 0)
        d = _hamming(node_desc[ch_safe], desc[:, None, :])   # (N, k)
        d = jnp.where(has_child, d, 1 << 20)
        best = jnp.argmin(d, -1)
        nxt = ch_safe[jnp.arange(n), best]
        # Stay put at leaves (no children).
        node = jnp.where(has_child.any(-1), nxt, node)
    w = word_id[node]
    return jnp.where(valid, w, -1)


def transform(voc: Vocabulary, desc: jnp.ndarray, valid: jnp.ndarray):
    """Descriptors (N, 8) -> word ids (N,), -1 for invalid."""
    return _transform_impl(voc.node_desc, voc.children, voc.word_id,
                           desc, valid, voc.depth)


def bow_vector(voc: Vocabulary, words: jnp.ndarray) -> jnp.ndarray:
    """Word ids (N,) -> L1-normalized tf-idf dense vector (n_words,)."""
    w_safe = jnp.where(words >= 0, words, voc.n_words)
    counts = jnp.zeros((voc.n_words + 1,), jnp.float32).at[w_safe].add(1.0)
    v = counts[:voc.n_words] * voc.idf
    norm = jnp.maximum(jnp.abs(v).sum(), 1e-9)
    return v / norm


def l1_score(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """DBoW2 L1 score in [0, 1] (ScoringObject.cpp:23):
    s = 1 - 0.5 * sum |a - b| for L1-normalized vectors.
    Supports batched b: (..., W)."""
    return 1.0 - 0.5 * jnp.abs(a - b).sum(-1)


@jax.jit
def score_against_database(query_vec: jnp.ndarray, db_vecs: jnp.ndarray,
                           db_valid: jnp.ndarray) -> jnp.ndarray:
    """(W,) vs (K, W) -> (K,) L1 scores; invalid rows get -1."""
    s = l1_score(query_vec, db_vecs)
    return jnp.where(db_valid, s, -1.0)
