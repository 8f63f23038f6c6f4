"""Ring attention: sequence-parallel attention over the ``seq`` ranks.

JAX counterpart: ``f5_tts_tpu/parallel/ring.py``.  Each of the ``sp`` seq
ranks keeps its frame shard of q, k and v [b, h, n/sp, d]; k and v travel
round the ring, one chunk a step, and each step merges one block's
attention into an online softmax carried in fp32.  After ``step``
rotations rank ``r`` holds the chunk that started on rank ``(r - step) %
sp``, global key columns ``[owner * nl, owner * nl + nl)``.  The key mask is
the reference's prefix padding mask, so within a chunk at offset ``o`` it is
again a prefix of length ``clip(lens - o, 0, nl)``: what lets the
single-prefix flash kernel serve as the block primitive unchanged.

Two blocks, both differentiable:

- ``xla`` (JAX's name; ``_block_scores_merge``): plain einsum scores and the
  online merge in fp32.
- ``flash`` (``_block_flash_merge``): the port's
  ``flash_attention_with_stats``, kernel C forward and kernels D and E
  backward for CUDA tensors (their plain versions for CPU tensors), merged
  in log space.  The merge weights read each block's logsumexp, so the
  backward hands D and E a non-zero logsumexp cotangent.

``auto`` means ``flash`` for CUDA tensors and ``xla`` for CPU tensors, at
any ``n / sp``: there is no shape gate (JAX's ``ring_supported_flash``
sends shards not a multiple of 256 to ``xla``).  An empty chunk (a row's
valid keys all on other ranks) gives o = 0 and L = -1e30 in the port's C,
the mean of v in JAX's; its merge weight is 0 once any chunk of the row has
a valid key, so the two agree wherever the row has one.

The rotation over a process group is a ``torch.autograd.Function``: its
forward sends k and v to rank ``(r + 1) % sp`` and receives from ``(r - 1)
% sp`` (``batch_isend_irecv``, which gloo has too), its backward sends the
cotangent the other way; JAX gets this from autodiff through ``ppermute``.
As JAX does, the next chunk's send and receive are issued before the
current block's compute and waited for after it.  ``ring_attention_in_process``
runs the same per-shard body for all ``sp`` shards in one process, the
rotation an index (shard r's step s reads chunk ``(r - s) % sp``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from f5_tts_tpu_torch.ops.flash_attention import flash_attention_with_stats

NEG_BIG = -1e30


def _block_scores_merge(q, k_cur, v_cur, lens, offset, scale, m, l, acc):
    """One ring step of the plain block: masked block scores and the online
    merge.  q [b, h, nl, d]; k_cur, v_cur [b, h, nc, d]; lens [b] global
    lengths; ``offset`` the held chunk's first global column.  (m, l, acc)
    are fp32."""
    nc = k_cur.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k_cur).float() * scale
    col = offset + torch.arange(nc, device=q.device)
    valid = col[None, :] < lens[:, None]  # [b, nc]
    s = torch.where(valid[:, None, None, :], s, NEG_BIG)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(dim=-1, keepdim=True)
    acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p.to(v_cur.dtype), v_cur).float()
    return m_new, l, acc


def _block_flash_merge(q, k_cur, v_cur, lens, offset, m, l, acc):
    """One ring step on ``flash_attention_with_stats`` (kernel C, and D, E
    backward, for CUDA tensors): the block's normalised output merged in
    log space by its logsumexp."""
    nc = k_cur.shape[2]
    lens_local = torch.clamp(lens - offset, 0, nc).to(torch.int32)
    out_b, L_b = flash_attention_with_stats(q, k_cur, v_cur, lens_local)
    lse = L_b[..., None]  # [b, h, nl, 1]
    m_new = torch.maximum(m, lse)
    w_old = torch.exp(m - m_new)
    w_b = torch.exp(lse - m_new)
    l = l * w_old + w_b
    acc = acc * w_old + out_b.float() * w_b
    return m_new, l, acc


def _resolve(block_impl: str, x: torch.Tensor) -> str:
    if block_impl == "auto":
        return "flash" if x.is_cuda else "xla"
    if block_impl not in ("flash", "xla"):
        raise ValueError(f"unknown ring block {block_impl!r} (auto | flash | xla)")
    return block_impl


def _ring_local(q, k, v, lens, *, my: int, sp: int, shift, block_impl: str,
                return_lse: bool = False):
    """The per-shard ring body.  q, k, v are this shard's frames [b, h, nl,
    d]; lens [b] the global valid lengths.  ``shift(step, k_cur, v_cur)``
    starts fetching the chunk held at ``step + 1`` and returns a callable
    that waits for it and returns it.  Returns o [b, h, nl, d] in q's dtype,
    and with ``return_lse`` the rows' logsumexp over all keys [b, h, nl]."""
    b, h, nl, d = q.shape
    impl = _resolve(block_impl, q)
    scale = d ** -0.5
    m = torch.full((b, h, nl, 1), NEG_BIG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, nl, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, nl, d), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for step in range(sp):
        owner = (my - step) % sp
        offset = owner * nl
        # issue the rotation before the block so the transfer overlaps it
        fetch = shift(step, k_cur, v_cur) if step + 1 < sp else None
        if impl == "flash":
            m, l, acc = _block_flash_merge(q, k_cur, v_cur, lens, offset, m, l, acc)
        else:
            m, l, acc = _block_scores_merge(q, k_cur, v_cur, lens, offset, scale, m, l, acc)
        if fetch is not None:
            k_cur, v_cur = fetch()
    o = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    if return_lse:
        return o, (m + torch.log(l))[..., 0]
    return o


class _GroupRing:
    """The neighbours of this rank on the seq group's ring."""

    def __init__(self, group):
        self.group = group
        ranks = dist.get_process_group_ranks(group)
        self.sp = len(ranks)
        self.my = dist.get_rank(group)
        self.next = ranks[(self.my + 1) % self.sp]
        self.prev = ranks[(self.my - 1) % self.sp]
        self.pending: list = []

    def exchange(self, sends, recvs, to: int, frm: int) -> list:
        ops = [dist.P2POp(dist.isend, t, to, self.group, tag=i) for i, t in enumerate(sends)]
        ops += [dist.P2POp(dist.irecv, t, frm, self.group, tag=i) for i, t in enumerate(recvs)]
        return dist.batch_isend_irecv(ops)


class _Rotate(torch.autograd.Function):
    """(k, v) -> the previous rank's (k, v), received into new buffers; the
    transfer is left pending on ``ring`` for the caller to wait on.  The
    backward sends the cotangent to the previous rank and receives the next
    rank's."""

    @staticmethod
    def forward(ctx, ring: _GroupRing, k, v):
        ctx.ring = ring
        k, v = k.detach().contiguous(), v.detach().contiguous()
        k_nxt, v_nxt = torch.empty_like(k), torch.empty_like(v)
        ring.pending = ring.exchange((k, v), (k_nxt, v_nxt), ring.next, ring.prev)
        return k_nxt, v_nxt

    @staticmethod
    def backward(ctx, gk, gv):
        ring = ctx.ring
        gk, gv = gk.contiguous(), gv.contiguous()
        out_k, out_v = torch.empty_like(gk), torch.empty_like(gv)
        for w in ring.exchange((gk, gv), (out_k, out_v),
                               ring.prev, ring.next):
            w.wait()
        return None, out_k, out_v


def group_shift(group):
    """``_ring_local``'s ``shift`` over a process group: (my, sp, shift)."""
    ring = _GroupRing(group)

    def shift(step, k_cur, v_cur):
        k_nxt, v_nxt = _Rotate.apply(ring, k_cur, v_cur)

        def wait():
            for w in ring.pending:
                w.wait()
            ring.pending = []
            return k_nxt, v_nxt

        return wait

    return ring.my, ring.sp, shift


def make_ring_attention_local(block_impl: str = "auto", group=None):
    """Attention backend ``(q, k, v, mask) -> o`` over the frame shards of
    one seq group (JAX ``make_ring_attention_local``, the per-shard body the
    pipeline slice will call).  q, k, v, mask are this rank's shards [b, h,
    nl, d] / [b, nl]; the global lengths are the sum of the shards' mask
    counts over the group (the padding mask is a global prefix, so the
    contiguous shards' counts add up to it)."""

    def backend(q, k, v, mask):
        b, _, nl, _ = q.shape
        if mask is None:
            lens = torch.full((b,), nl, dtype=torch.int32, device=q.device)
        else:
            lens = mask.sum(dim=-1, dtype=torch.int32)
        my, sp, shift = group_shift(group)
        if sp > 1:
            dist.all_reduce(lens, group=group)
        return _ring_local(q, k, v, lens, my=my, sp=sp, shift=shift, block_impl=block_impl)

    return backend


def make_ring_attention(mesh, block_impl: str = "auto"):
    """Attention backend over ``mesh``'s ``seq`` axis (``ops/attention.py``
    takes a callable backend).  With no GSPMD the frames arrive sharded:
    ``parallel/sequence.py``'s hook slices the hidden states before the
    blocks, so q, k, v and the mask are this rank's shards.  ``block_impl``:
    ``auto`` (C for CUDA tensors, the plain block for CPU tensors), ``flash``
    or ``xla``."""
    from f5_tts_tpu_torch.parallel.mesh import SEQ_AXIS

    if SEQ_AXIS not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh {mesh.mesh_dim_names} has no '{SEQ_AXIS}' axis")
    return make_ring_attention_local(block_impl, group=mesh.get_group(SEQ_AXIS))


def ring_attention_in_process(q, k, v, lens, sp: int, block_impl: str = "auto",
                              return_lse: bool = False):
    """Ring attention over ``sp`` shards of the full q, k, v [b, h, n, d] in
    one process: each shard runs the per-shard body, its step s reading
    chunk ``(r - s) % sp``.  Returns o [b, h, n, d] (and L [b, h, n]) as the
    shards' outputs concatenated; gradients flow to the full tensors."""
    n = q.shape[2]
    if n % sp:
        raise ValueError(f"frames {n} do not divide over {sp} shards")
    qs, ks, vs = (t.chunk(sp, dim=2) for t in (q, k, v))
    outs = []
    for r in range(sp):
        def shift(step, k_cur, v_cur, r=r):
            owner = (r - step - 1) % sp
            return lambda: (ks[owner], vs[owner])

        outs.append(_ring_local(qs[r], ks[r], vs[r], lens, my=r, sp=sp, shift=shift,
                                block_impl=block_impl, return_lse=return_lse))
    if return_lse:
        return torch.cat([o for o, _ in outs], dim=2), torch.cat([L for _, L in outs], dim=2)
    return torch.cat(outs, dim=2)
