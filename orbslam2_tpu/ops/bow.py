"""Batched vocabulary-tree descent + BoW vector construction (device).

JAX-native replacement for DBoW2's per-feature `transform`
(Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:1241-1279): all keypoints
descend the tree simultaneously — per level one gather of the candidate
child descriptors and one XOR-popcount argmin. The sparse BowVector becomes
a dense [n_words] vector (segment-sum of idf weights, L1-normalized), which
turns place-recognition scoring (DBoW2/ScoringObject.cpp L1 scoring) into a
plain matvec against the keyframe-vector matrix.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


# Depth of the FeatureVector node gate (DBoW2 levelsup: ORB-SLAM2 stores
# nodes 4 levels above the leaves of its L=6 k=10 vocabulary — depth 2,
# ~100 groups; src/ORBmatcher.cpp:243-299 compares only descriptors under
# the same node). Same depth here: the default k=11 L=5 vocabulary has 121
# depth-2 nodes.
GATE_DEPTH = 2


@functools.partial(jax.jit, static_argnames=("levels",))
def assign_words(node_desc, node_children, node_word, desc, valid,
                 levels: int):
    """Tree descent for all descriptors at once.

    node_desc: [N, 8] u32; node_children: [N, k] i32 (-1 pad);
    node_word: [N] i32 (leaf word id or -1); desc: [M, 8] u32.
    Returns (word ids [M] (0 where invalid), valid [M], gate node ids [M] —
    the node reached at depth GATE_DEPTH, the reference's FeatureVector
    entry used for node-gated SearchByBoW).
    """
    M = desc.shape[0]
    nid = jnp.zeros((M,), jnp.int32)
    gate = nid
    for lv in range(levels):
        ch = node_children[nid]                      # [M, k]
        ch_desc = node_desc[jnp.clip(ch, 0)]          # [M, k, 8]
        x = jnp.bitwise_xor(ch_desc, desc[:, None, :])
        dist = jnp.sum(jax.lax.population_count(x), axis=-1)
        dist = jnp.where(ch >= 0, dist, 1 << 20)
        best = jnp.take_along_axis(ch, jnp.argmin(dist, -1)[:, None], 1)[:, 0]
        # stop at leaves / childless nodes
        has_child = (ch >= 0).any(-1)
        nid = jnp.where(has_child & (node_word[nid] < 0), best, nid)
        if lv == GATE_DEPTH - 1:
            gate = nid
    w = node_word[nid]
    ok = valid & (w >= 0)
    return jnp.where(ok, w, 0), ok, jnp.where(ok, gate, -1)


@functools.partial(jax.jit, static_argnames=("n_words",))
def bow_vector(words, wvalid, word_weight, n_words: int):
    """Dense L1-normalized tf-idf vector [n_words] from per-feature words."""
    contrib = jnp.where(wvalid, word_weight[jnp.clip(words, 0, n_words - 1)], 0.0)
    v = jax.ops.segment_sum(contrib, jnp.clip(words, 0, n_words - 1),
                            num_segments=n_words)
    return v / jnp.maximum(jnp.sum(v), 1e-9)


def l1_scores(query, kf_vectors):
    """DBoW2 L1 score s = 1 - 0.5 * |q - v|_1 for L1-normalized vectors.
    query: [V]; kf_vectors: [K, V]. Returns [K]."""
    return 1.0 - 0.5 * jnp.sum(jnp.abs(kf_vectors - query[None, :]), axis=-1)
