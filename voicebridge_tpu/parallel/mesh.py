"""Device-mesh parallelism: data-parallel EM over pjit/shard_map.

Replaces the reference's entire parallel runtime — ``SplitData`` +
``std::thread`` per shard + per-job accumulator files + ``GmmSumAccs``
(SURVEY.md §2.6) — with a mesh:

* utterances are sharded over the ``data`` axis ([B, ...] leading dim);
* GMM parameters and decode graphs are replicated (a ``model`` axis exists for
  sharding very large mixture inventories later);
* E-step sufficient statistics are ``psum``-reduced over ``data`` — the
  file-barrier reduction becomes one collective.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import align_band as AB
from ..ops import gmm_kernels as K
from ..ops import viterbi as V

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(num_data: int | None = None, num_model: int = 1,
              devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    if num_data is None:
        num_data = len(devices) // num_model
    dev = np.asarray(devices[: num_data * num_model]).reshape(num_data, num_model)
    return Mesh(dev, (DATA_AXIS, MODEL_AXIS))


def shard_batch(mesh: Mesh, tree):
    """Place leading-axis-sharded arrays on the mesh (data-parallel)."""
    sharding = NamedSharding(mesh, P(DATA_AXIS))
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)


def replicate(mesh: Mesh, tree):
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)


def em_estep_sharded(mesh: Mesh, num_states: int, num_pdfs: int, num_tids: int):
    """Build the jitted, mesh-sharded EM E-step:

    (gmm params, per-utterance padded graphs, feats, frame counts, acwt)
      -> (alpha_end, backpointers, stats psum-reduced over the data axis)

    The Viterbi forward runs sharded (each chip advances its own utterances);
    statistics are computed from the *previous* iteration's alignments
    (tids/weights) and reduced with psum — matching the reference's EM loop
    structure where realignment and stats use the current model (§3.1).
    """
    from jax import shard_map  # keyword-only API (jax >= 0.8)

    data_spec = P(DATA_AXIS)
    rep = P()

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(rep,  # params
                  data_spec, data_spec, data_spec, data_spec, data_spec,  # graphs (incl. levels tuple)
                  data_spec, data_spec,  # feats, num_frames
                  data_spec, data_spec, data_spec,  # tids, pdf_ids, weights
                  rep),  # acoustic scale
        # bps is [T, B, S]: the batch axis is dim 1
        out_specs=(data_spec, P(None, DATA_AXIS), rep, rep, rep, rep, rep),
        check_vma=False,
    )
    def step(params, arc_src, levels, arc_pdf, arc_score, alpha0,
             feats, num_frames, tids, pdf_ids_in, weights, acwt):
        b, t, d = feats.shape
        ll = K.loglikes_batch(params, feats)
        alpha_end, bps = V.viterbi_forward_batched(
            arc_src, levels, arc_pdf, arc_score, alpha0,
            ll, num_frames, acwt, jnp.float32(1e9), num_states)
        # stats from given alignments (previous realign), psum over mesh
        x = feats.reshape(b * t, d)
        pdf_ids = pdf_ids_in.reshape(-1)
        w = weights.reshape(-1)
        occ, macc, vacc, ll_tot = K.acc_gmm_stats_aligned(
            params, x, pdf_ids, num_pdfs, w)
        tstats = K.acc_transition_stats(tids.reshape(-1), num_tids, w)
        occ = jax.lax.psum(occ, DATA_AXIS)
        macc = jax.lax.psum(macc, DATA_AXIS)
        vacc = jax.lax.psum(vacc, DATA_AXIS)
        tstats = jax.lax.psum(tstats, DATA_AXIS)
        ll_tot = jax.lax.psum(ll_tot, DATA_AXIS)
        return alpha_end, bps, occ, macc, vacc, tstats, ll_tot

    return jax.jit(step)


def pad_to_mesh(mesh: Mesh, feats: np.ndarray, ids: np.ndarray,
                weights: np.ndarray | None = None):
    """Pad frame-major arrays so N divides the data-axis size, returning
    (feats, ids, weights) with zero weight on the padding rows (so padded
    frames contribute nothing to any psum-reduced statistic)."""
    n = feats.shape[0]
    nd = mesh.shape[DATA_AXIS]
    w = (np.ones(n, np.float32) if weights is None
         else np.asarray(weights, np.float32))
    n_pad = -(-max(n, 1) // nd) * nd
    if n_pad != n:
        feats = np.concatenate(
            [feats, np.zeros((n_pad - n,) + feats.shape[1:], feats.dtype)])
        ids = np.concatenate([ids, np.zeros(n_pad - n, ids.dtype)])
        w = np.concatenate([w, np.zeros(n_pad - n, np.float32)])
    return feats, ids, w


def acc_lda_stats_sharded(mesh: Mesh, num_pdfs: int):
    """Mesh-sharded LDA accumulation (SURVEY §2.6 P2: the reference sums
    per-job ``lda.JOBID.acc`` files, ``train_lda_mllt.cpp:305-376``): frames
    sharded over the data axis, class-stats psum-reduced.

    -> jitted acc(feats [N, D], pdf_ids [N], weights [N]) ->
    (counts [C], mean_acc [C, D], scatter [D, D]) — identical to
    ``transforms.lda.acc_lda_stats`` on the concatenated frames."""
    from jax import shard_map

    from ..transforms.lda import acc_lda_stats

    data = P(DATA_AXIS)

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(data, data, data),
                       out_specs=(P(), P(), P()), check_vma=False)
    def acc(feats, pdf_ids, weights):
        counts, mean_acc, scatter = acc_lda_stats(feats, pdf_ids, weights,
                                                  num_pdfs)
        return (jax.lax.psum(counts, DATA_AXIS),
                jax.lax.psum(mean_acc, DATA_AXIS),
                jax.lax.psum(scatter, DATA_AXIS))

    return jax.jit(acc)


def acc_mllt_stats_sharded(mesh: Mesh):
    """Mesh-sharded MLLT accumulation (reference: per-job ``m.JOBID.macc``
    summed by est-mllt, ``train_lda_mllt.cpp:694-``): frames sharded over
    the data axis, (G [D, D, D], beta) psum-reduced.

    -> jitted acc(params, means [P, M, D], inv_vars, feats [N, D],
    pdf_ids [N], weights [N]) -> (G, beta)."""
    from jax import shard_map

    from ..transforms.mllt import _mllt_chunk

    data = P(DATA_AXIS)
    rep = P()

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(rep, rep, rep, data, data, data),
                       out_specs=(P(), P()), check_vma=False)
    def acc(params, means, inv_vars, feats, pdf_ids, weights):
        g, beta = _mllt_chunk(params, means, inv_vars, feats, pdf_ids,
                              weights)
        return jax.lax.psum(g, DATA_AXIS), jax.lax.psum(beta, DATA_AXIS)

    return jax.jit(acc)


def acc_fmllr_stats_sharded(mesh: Mesh, num_speakers: int):
    """Mesh-sharded per-speaker fMLLR accumulation (reference: per-job
    fMLLR accs composed per speaker, ``train_sat.cpp:906-954``).  SPEAKERS
    are sharded over the data axis in a speaker-major layout — the P4
    speaker-affinity design (SURVEY §2.6): every frame of a speaker lives
    on one chip, so the per-speaker contractions are chip-local and the
    final psum only merges DISJOINT speaker slots.

    -> jitted acc(params, means, inv_vars, feats [S, T, D] speaker-major
    padded slabs, pdf_ids [S, T], weights [S, T] (0 on padding),
    spk_slot [S] global speaker slot per row) ->
    (beta [S_tot], K [S_tot, D, D+1], G [S_tot, D, D+1, D+1])."""
    from jax import shard_map

    from ..transforms.fmllr import _fmllr_frame_stats

    data = P(DATA_AXIS)
    rep = P()

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(rep, rep, rep, data, data, data, data),
                       out_specs=(P(), P(), P()), check_vma=False)
    def acc(params, means, inv_vars, feats, pdf_ids, weights, spk_slot):
        s, t, d = feats.shape

        def one_speaker(f, pid, w):
            gmass, w_miv, w_iv = _fmllr_frame_stats(
                params, means, inv_vars, f, pid, w)
            xhat = jnp.concatenate([f, jnp.ones((t, 1), f.dtype)], axis=1)
            beta = jnp.sum(gmass)
            k = jnp.einsum("nd,ne->de", w_miv, xhat,
                           precision=jax.lax.Precision.HIGHEST)
            y = w_iv[:, :, None] * xhat[:, None, :]
            g = jnp.einsum("nde,nf->def", y, xhat,
                           precision=jax.lax.Precision.HIGHEST)
            return beta, k, g

        beta, k, g = jax.vmap(one_speaker)(feats, pdf_ids, weights)
        # scatter local speaker rows into disjoint global slots, then psum
        # merges the shards (slots never collide across chips)
        beta_g = jax.ops.segment_sum(beta, spk_slot, num_speakers)
        k_g = jax.ops.segment_sum(k, spk_slot, num_speakers)
        g_g = jax.ops.segment_sum(g, spk_slot, num_speakers)
        return (jax.lax.psum(beta_g, DATA_AXIS),
                jax.lax.psum(k_g, DATA_AXIS),
                jax.lax.psum(g_g, DATA_AXIS))

    return jax.jit(acc)


def acc_tree_stats_sharded(mesh: Mesh, num_events: int):
    """Mesh-sharded tree-statistics accumulation (reference: per-job
    ``JOBID.treeacc`` summed by sum-tree-stats, ``train_deltas.cpp:294``):
    frames sharded over the data axis, per-event Gaussian stats
    psum-reduced.  Event ids are built host-side
    (models/treebuild.frame_event_ids — the keying is string-like tuple
    work); the O(N) accumulation is the device part.

    -> jitted acc(feats [N, D], event_ids [N], weights [N]) ->
    (count [E], sum_x [E, D], sum_x2 [E, D])."""
    from jax import shard_map

    data = P(DATA_AXIS)

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(data, data, data),
                       out_specs=(P(), P(), P()), check_vma=False)
    def acc(feats, event_ids, weights):
        cnt = jax.ops.segment_sum(weights, event_ids, num_events)
        sx = jax.ops.segment_sum(feats * weights[:, None], event_ids,
                                 num_events)
        sx2 = jax.ops.segment_sum(feats * feats * weights[:, None],
                                  event_ids, num_events)
        return (jax.lax.psum(cnt, DATA_AXIS), jax.lax.psum(sx, DATA_AXIS),
                jax.lax.psum(sx2, DATA_AXIS))

    return jax.jit(acc)


def decode_forward_sharded(mesh: Mesh, packed: bool, rspec: tuple):
    """Mesh-sharded decode forward over a replicated HCLG: the production
    in-degree-row kernel (ops/decode_core.viterbi_scan) with utterances
    data-parallel in the batch-minor layout (batch is the LAST axis of the
    ``alpha [S+1, B]`` slabs and of ``bps [T, S+1, B]``), the EmitPlan
    replicated, and no cross-device communication in the forward itself —
    the P1 design (SURVEY.md §2.6): each chip advances its own utterances,
    hypotheses join on the host.

    -> jitted step(dev: EmitPlanDev, alpha, alpha_end, loglikes [B, T, P],
    num_frames [B], acwt) -> (alpha, alpha_end, bps)."""
    from jax import shard_map

    from ..ops import decode_core as DC

    rep = P()
    batch_minor = P(None, DATA_AXIS)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(rep, batch_minor, batch_minor, P(DATA_AXIS), P(DATA_AXIS),
                  rep),
        out_specs=(batch_minor, batch_minor, P(None, None, DATA_AXIS)),
        check_vma=False,
    )
    def step(dev, alpha, alpha_end, loglikes, num_frames, acwt):
        (a, ae), bps = DC.viterbi_scan(
            dev, alpha, alpha_end, loglikes, num_frames, jnp.int32(0),
            acwt, jnp.float32(0.0), rspec, packed, False)
        return a, ae, bps

    return jax.jit(step)


def em_estep_sharded_banded(mesh: Mesh, num_pdfs: int, num_tids: int,
                            offsets: tuple):
    """Banded-kernel variant of :func:`em_estep_sharded` — the production
    alignment path (ops/align_band.py: gather-free shifts + one-hot matmul
    emissions) sharded over the data axis.  Inputs take the BandPlan arrays
    (W [B,S,K], pdf [B,S], alpha0 [B,S]) in place of padded arc arrays;
    ``offsets`` is the plan's static band-offset tuple.  T must be a
    multiple of 128, or at most 128."""
    from jax import shard_map

    data_spec = P(DATA_AXIS)
    rep = P()

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(rep,  # params
                  data_spec, data_spec, data_spec,  # W, pdf, alpha0
                  data_spec, data_spec,  # feats, num_frames
                  data_spec, data_spec, data_spec,  # tids, pdf_ids, weights
                  rep),  # acoustic scale
        out_specs=(data_spec, P(None, DATA_AXIS), rep, rep, rep, rep, rep),
        check_vma=False,
    )
    def step(params, w_band, pdf_band, alpha0, feats, num_frames, tids,
             pdf_ids_in, weights, acwt):
        b, t, d = feats.shape
        assert t <= 128 or t % 128 == 0, \
            "banded EM step: T must be <=128 or a multiple of 128"
        ll = K.loglikes_batch(params, feats)
        alpha_end, bps = AB.viterbi_forward_banded(
            w_band, pdf_band, alpha0, ll, num_frames, acwt, offsets,
            t_chunk=min(t, 128))
        x = feats.reshape(b * t, d)
        pdf_ids = pdf_ids_in.reshape(-1)
        w = weights.reshape(-1)
        occ, macc, vacc, ll_tot = K.acc_gmm_stats_aligned(
            params, x, pdf_ids, num_pdfs, w)
        tstats = K.acc_transition_stats(tids.reshape(-1), num_tids, w)
        occ = jax.lax.psum(occ, DATA_AXIS)
        macc = jax.lax.psum(macc, DATA_AXIS)
        vacc = jax.lax.psum(vacc, DATA_AXIS)
        tstats = jax.lax.psum(tstats, DATA_AXIS)
        ll_tot = jax.lax.psum(ll_tot, DATA_AXIS)
        return alpha_end, bps, occ, macc, vacc, tstats, ll_tot

    return jax.jit(step)
