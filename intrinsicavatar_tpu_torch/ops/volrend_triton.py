"""Triton kernels of KD's composite and of KD' (see ``ops/volrend.py`` for
what they replace and why they are shaped so).

``triton`` exists only on a machine with a card, so importing this module
imports nothing; :func:`load`, called by the launching functions of
``ops/volrend.py``, imports Triton and defines the kernels as module
globals (Triton resolves the names a kernel uses in its module's globals).
"""

triton = tl = None
composite_kernel = composite_bwd_kernel = None
_alpha = _alpha_parts = _sample_cot = _affine = None


def block(S: int) -> int:
    """One block holds a whole row of samples."""
    return 1 << max(int(S) - 1, 0).bit_length()


def load():
    global triton, tl, composite_kernel, composite_bwd_kernel
    global _alpha, _alpha_parts, _sample_cot, _affine
    if composite_kernel is not None:
        return
    import triton
    import triton.language as tl

    @triton.jit
    def _alpha(sdf, dist, beta):
        # 1 - exp(-density * dist), VolSDF Laplace density
        sgn = tl.where(sdf > 0, 1.0, tl.where(sdf < 0, -1.0, 0.0))
        dens = (1.0 / beta) * (0.5 + 0.5 * sgn
                               * (tl.exp(-tl.abs(sdf) / beta) - 1.0))
        return 1.0 - tl.exp(-dens * dist)

    @triton.jit
    def composite_kernel(sdf_ptr, dist_ptr, beta_ptr, mask_ptr, rgb_ptr,
                         nrm_ptr, mid_ptr, alpha_ptr, w_ptr, out_ptr, S,
                         BLOCK: tl.constexpr):
        r = tl.program_id(0).to(tl.int64)
        base = r * S
        offs = tl.arange(0, BLOCK)
        inb = offs < S
        beta = tl.load(beta_ptr)
        m = tl.load(mask_ptr + base + offs, mask=inb, other=0) != 0
        a = _alpha(tl.load(sdf_ptr + base + offs, mask=inb, other=0.0),
                   tl.load(dist_ptr + base + offs, mask=inb, other=0.0), beta)
        a = tl.where(m, a, 0.0)
        pin = (offs >= 1) & inb
        mp = tl.load(mask_ptr + base + offs - 1, mask=pin, other=0) != 0
        ap = _alpha(tl.load(sdf_ptr + base + offs - 1, mask=pin, other=0.0),
                    tl.load(dist_ptr + base + offs - 1, mask=pin, other=0.0),
                    beta)
        ap = tl.where(mp, ap, 0.0)
        w = tl.where(m, a * tl.cumprod(1.0 - ap, axis=0), 0.0)
        tl.store(alpha_ptr + base + offs, a, mask=inb)
        tl.store(w_ptr + base + offs, w, mask=inb)
        # out row: rgb (3), normal (3), opacity, depth
        o = out_ptr + r * 8
        for c in tl.static_range(3):
            v = tl.load(rgb_ptr + (base + offs) * 3 + c, mask=inb, other=0.0)
            tl.store(o + c, tl.sum(w * v, axis=0))
            v = tl.load(nrm_ptr + (base + offs) * 3 + c, mask=inb, other=0.0)
            tl.store(o + 3 + c, tl.sum(w * v, axis=0))
        tl.store(o + 6, tl.sum(w, axis=0))
        v = tl.load(mid_ptr + base + offs, mask=inb, other=0.0)
        tl.store(o + 7, tl.sum(w * v, axis=0))

    @triton.jit
    def _alpha_parts(sdf, dist, beta):
        # sign(sdf), exp(-|sdf| / beta), the density and exp(-density * dist)
        sgn = tl.where(sdf > 0, 1.0, tl.where(sdf < 0, -1.0, 0.0))
        e = tl.exp(-tl.abs(sdf) / beta)
        dens = (1.0 / beta) * (0.5 + 0.5 * sgn * (e - 1.0))
        return sgn, e, dens, tl.exp(-dens * dist)

    @triton.jit
    def _sample_cot(idx, ld, m, gw_ptr, rgb_ptr, nrm_ptr, mid_ptr, gout_ptr,
                    r):
        # the cotangent reaching each sample's weight: d weights plus the
        # rgb, normal, opacity and depth sums' cotangents against the sample
        go = gout_ptr + r * 8
        gv = tl.load(gw_ptr + idx, mask=ld, other=0.0) + tl.load(go + 6) \
            + tl.load(mid_ptr + idx, mask=ld, other=0.0) * tl.load(go + 7)
        for c in tl.static_range(3):
            gv += tl.load(rgb_ptr + idx * 3 + c, mask=ld, other=0.0) \
                * tl.load(go + c)
            gv += tl.load(nrm_ptr + idx * 3 + c, mask=ld, other=0.0) \
                * tl.load(go + 3 + c)
        return tl.where(m, gv, 0.0)

    @triton.jit
    def _affine(a1, b1, a2, b2):
        # compose x -> a1 x + b1 (the samples scanned first) with
        # x -> a2 x + b2
        return a1 * a2, b1 * a2 + b2

    @triton.jit
    def composite_bwd_kernel(sdf_ptr, dist_ptr, beta_ptr, mask_ptr, rgb_ptr,
                             nrm_ptr, mid_ptr, gw_ptr, gout_ptr, dsdf_ptr,
                             dbeta_ptr, drgb_ptr, dnrm_ptr, q_ptr, S,
                             BLOCK: tl.constexpr):
        r = tl.program_id(0).to(tl.int64)
        base = r * S
        offs = tl.arange(0, BLOCK)
        inb = offs < S
        beta = tl.load(beta_ptr)
        idx = base + offs
        m = tl.load(mask_ptr + idx, mask=inb, other=0) != 0
        sdf = tl.load(sdf_ptr + idx, mask=inb, other=0.0)
        dist = tl.load(dist_ptr + idx, mask=inb, other=0.0)
        sgn, e, dens, ex = _alpha_parts(sdf, dist, beta)
        a = tl.where(m, 1.0 - ex, 0.0)
        # exclusive transmittance, as in the forward
        pin = (offs >= 1) & inb
        mp = tl.load(mask_ptr + idx - 1, mask=pin, other=0) != 0
        _, _, _, exp_ = _alpha_parts(
            tl.load(sdf_ptr + idx - 1, mask=pin, other=0.0),
            tl.load(dist_ptr + idx - 1, mask=pin, other=0.0), beta)
        trans = tl.cumprod(1.0 - tl.where(mp, 1.0 - exp_, 0.0), axis=0)
        w = a * trans
        gv = _sample_cot(idx, inb, m, gw_ptr, rgb_ptr, nrm_ptr, mid_ptr,
                         gout_ptr, r)
        # Q_j = alpha_j gv_j + (1 - alpha_j) Q_{j+1}: a forward scan over
        # the row loaded back to front (position p holds sample S-1-p)
        jdx = base + (S - 1 - offs)
        mj = tl.load(mask_ptr + jdx, mask=inb, other=0) != 0
        _, _, _, exj = _alpha_parts(
            tl.load(sdf_ptr + jdx, mask=inb, other=0.0),
            tl.load(dist_ptr + jdx, mask=inb, other=0.0), beta)
        aj = tl.where(mj, 1.0 - exj, 0.0)
        gvj = _sample_cot(jdx, inb, mj, gw_ptr, rgb_ptr, nrm_ptr, mid_ptr,
                          gout_ptr, r)
        _, q = tl.associative_scan(
            (tl.where(inb, 1.0 - aj, 1.0), tl.where(inb, aj * gvj, 0.0)),
            0, _affine)
        tl.store(q_ptr + jdx, q, mask=inb)
        tl.debug_barrier()
        # R_i = Q_{i+1}, read back in sample order
        nxt = (offs + 1) < S
        rec = tl.load(q_ptr + idx + 1, mask=nxt, other=0.0)
        d_alpha = tl.where(m, trans * (gv - rec), 0.0)
        common = d_alpha * dist * ex
        tl.store(dsdf_ptr + idx,
                 common * (-0.5 / (beta * beta)) * e * (sgn * sgn), mask=inb)
        db = common * (-dens / beta + 0.5 / beta * sgn * e * tl.abs(sdf)
                       / (beta * beta))
        tl.store(dbeta_ptr + r, tl.sum(tl.where(inb, db, 0.0), axis=0))
        go = gout_ptr + r * 8
        for c in tl.static_range(3):
            tl.store(drgb_ptr + idx * 3 + c, w * tl.load(go + c), mask=inb)
            tl.store(dnrm_ptr + idx * 3 + c, w * tl.load(go + 3 + c),
                     mask=inb)
