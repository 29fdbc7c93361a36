"""Keyframe database: BoW signatures, loop/reloc candidate mining.

Replaces ``KeyFrameDatabase`` (/root/reference/src/KeyFrameDatabase.cc): the
word->KF inverted file + accumulated-score candidate search
(``DetectNBestCandidates`` :649, ``DetectRelocalizationCandidates`` :827)
becomes a dense (K, W) tf-idf matrix scored with one matvec
(see ops/bow.py design note).

Also hosts SearchByBoW-style matching masks: keypoint pairs are candidates
iff they land in the same vocabulary word (ORBmatcher::SearchByBoW :260).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import bow, matching


class KeyframeDatabase:
    """Host-side container of per-keyframe BoW data (device arrays)."""

    def __init__(self, voc: bow.Vocabulary, max_kf: int, n_feat: int):
        self.voc = voc
        self.vecs = jnp.zeros((max_kf, voc.n_words), jnp.float32)
        self.words = jnp.full((max_kf, n_feat), -1, jnp.int32)
        self.valid = jnp.zeros((max_kf,), bool)

    def add(self, kf_id: int, desc: jnp.ndarray, kp_valid: jnp.ndarray):
        words = bow.transform(self.voc, desc, kp_valid)
        vec = bow.bow_vector(self.voc, words)
        self.vecs = self.vecs.at[kf_id].set(vec)
        self.words = self.words.at[kf_id].set(words)
        self.valid = self.valid.at[kf_id].set(True)

    def remap(self, old2new: np.ndarray, n_valid: int):
        """Keyframe slots were compacted (map_state.compact_keyframes):
        gather the BoW rows into their new slots and drop dead entries."""
        max_kf = self.valid.shape[0]
        old_of_new = np.zeros(max_kf, np.int64)
        live = np.where(old2new >= 0)[0]
        old_of_new[old2new[live]] = live
        g = jnp.asarray(old_of_new)
        keep = jnp.arange(max_kf) < n_valid
        self.vecs = jnp.where(keep[:, None], self.vecs[g], 0.0)
        self.words = jnp.where(keep[:, None], self.words[g], -1)
        self.valid = self.valid[g] & keep

    def query(self, desc: jnp.ndarray, kp_valid: jnp.ndarray,
              exclude: np.ndarray | None = None, top_n: int = 3,
              min_score: float = 0.0):
        """Top-N candidate keyframes by L1 BoW score.

        exclude: boolean (K,) mask of KFs to skip (covisible set for loop
        detection — KeyFrameDatabase.cc:667 skips the connected group).
        Returns (ids (top_n,), scores (top_n,)) as numpy; id -1 = none.
        """
        words = bow.transform(self.voc, desc, kp_valid)
        qv = bow.bow_vector(self.voc, words)
        valid = self.valid
        if exclude is not None:
            valid = valid & ~jnp.asarray(exclude)
        scores = bow.score_against_database(qv, self.vecs, valid)
        top_s, top_i = jax.lax.top_k(scores, top_n)
        top_s = np.asarray(top_s)
        top_i = np.asarray(top_i)
        ids = np.where(top_s >= max(min_score, 1e-6), top_i, -1)
        return ids, top_s, words

    def query_groups(self, desc: jnp.ndarray, kp_valid: jnp.ndarray,
                     covis: jnp.ndarray, exclude: np.ndarray | None = None,
                     top_n: int = 3, n_covisibles: int = 10):
        """Covisibility-group accumulated candidate scoring
        (DetectNBestCandidates, /root/reference/src/KeyFrameDatabase.cc:649):

          1. common-words count per stored KF, gated at
             >= 0.8 x max-common-words (:714);
          2. L1 tf-idf score for the survivors;
          3. per-candidate group score = own + top-``n_covisibles``
             covisible neighbours' scores (:738-760); each group reports
             its best-scoring member;
          4. top-N groups, deduplicated by best member.

        covis: (K, K) shared-landmark counts (ms.covisibility_matrix).
        Returns (ids, acc_scores, words) like ``query``; all scoring is one
        fused device computation, read back once.
        """
        words = bow.transform(self.voc, desc, kp_valid)
        qv = bow.bow_vector(self.voc, words)
        valid = self.valid
        if exclude is not None:
            valid = valid & ~jnp.asarray(exclude)

        # Distinct-shared-word counts: one (W,) x (K, W) mask matvec.
        qmask = (qv > 0).astype(jnp.float32)
        kmask = (self.vecs > 0).astype(jnp.float32)
        common = kmask @ qmask
        max_common = jnp.max(jnp.where(valid, common, 0.0))
        pass_gate = valid & (common > 0.8 * max_common) & (common > 0)

        scores = bow.score_against_database(qv, self.vecs, valid)
        s_g = jnp.where(pass_gate, scores, 0.0)

        # Group accumulation over each candidate's best covisible
        # neighbours (only members that themselves share words count —
        # s_g is already zero elsewhere).
        cv, ci = jax.lax.top_k(covis, n_covisibles)       # (K, n)
        nb_ok = cv > 0
        nb_scores = jnp.where(nb_ok, s_g[ci], 0.0)
        acc = s_g + nb_scores.sum(-1)
        acc = jnp.where(pass_gate, acc, 0.0)
        # Best member per group (the KF the verification ladder runs on).
        member_scores = jnp.concatenate([s_g[:, None], nb_scores], -1)
        member_ids = jnp.concatenate(
            [jnp.arange(covis.shape[0])[:, None], ci], -1)
        best = member_ids[jnp.arange(covis.shape[0]),
                          jnp.argmax(member_scores, -1)]

        k = min(top_n * 3, covis.shape[0])   # headroom for dedup
        top_acc, top_group = jax.lax.top_k(acc, k)
        top_best = best[top_group]
        top_acc = np.asarray(top_acc)
        top_best = np.asarray(top_best)
        ids, out_s, seen = [], [], set()
        for b, s in zip(top_best.tolist(), top_acc.tolist()):
            if s <= 1e-6 or b in seen:
                continue
            seen.add(b)
            ids.append(b)
            out_s.append(s)
            if len(ids) == top_n:
                break
        while len(ids) < top_n:
            ids.append(-1)
            out_s.append(0.0)
        return np.asarray(ids), np.asarray(out_s), words

    def word_pair_mask(self, words_a: jnp.ndarray, kf_id: int) -> jnp.ndarray:
        """(Na, Nb) mask: same vocabulary word (SearchByBoW bucket gate)."""
        words_b = self.words[kf_id]
        return (words_a[:, None] == words_b[None, :]) & (words_a[:, None] >= 0)
