"""Joins of ``.mut`` tables against VCF/BCF genotype evidence.

``join_vcfvcf`` replicates parse_vcfvcf (coal/coal.cpp:906-1227)
vectorised; output is the same :class:`JoinedSites` the tmptmp join
produces, so binning/bootstrap/EM are shared.

Semantics (all exact):
- row filters: flipped==0, one branch, age_begin<age_end, age_end>=age,
  nonempty alleles, anc != der, anc in {A,C,G,T,0}, der in {A,C,G,T,1},
  masks 'P' at bp-1 when in range (coal.cpp:968-999);
- reference stream: cursor advances while bp_ref < bp_mut (only for
  rows surviving the filters); site "exists" iff the cursor record's
  position equals bp_mut — no consumed-record requirement (unlike
  tmptmp); allele match straight or flipped against REF/first-ALT;
  non-biallelic rejects; missing genotypes count -1 into DAF
  (bcf_gt_allele); absent sites fall back to the ref genome: derived
  match ⇒ DAF_ref = N_ref, else reject (coal.cpp:1005-1060);
  DAF_ref == 0 rejects (but negative DAF_ref from missing GT passes);
- target stream: advances only for rows surviving the reference stage;
  fixed-for-ref records (no ALT) accept only if the REF allele matches
  anc or der AND the genotype sum is 0 (coal.cpp:1089-1117); absent
  sites use the ref genome (derived ⇒ DAF=N_target, ancestral ⇒ 0,
  else reject);
- weights: w_shared = DAF_target*DAF_ref/N_ref,
  w_notshared = (N_target-DAF_target)*DAF_ref/N_ref — raw counts, no
  pseudo-diploid rounding (unlike tmptmp);
- 30 Mb block ids advance per used site; one block boundary per
  chromosome end (coal.cpp:1139-1146, 1211-1216).

Copied from colate_tpu/pipeline/join_vcf.py with its imports rewritten.
"""

from __future__ import annotations

import sys

import numpy as np

from colate_tpu_torch.config import NUM_BASES_PER_BLOCK
from colate_tpu_torch.formats.fasta import read_fasta, read_mask
from colate_tpu_torch.formats.mut import MutTable
from colate_tpu_torch.formats.vcf import VcfTable, read_vcf
from colate_tpu_torch.pipeline.join import JoinedSites, _mask_pass, allele_codes


def _single_char_codes(strings: np.ndarray) -> np.ndarray:
    """uint8 code of each string when it is exactly one char, else 0."""
    out = np.zeros(strings.shape[0], np.uint8)
    for i, s in enumerate(strings):
        if len(s) == 1:
            out[i] = ord(s)
    return out


def _vcf_columns(vt: VcfTable):
    ref1 = _single_char_codes(vt.ref)
    alt1 = _single_char_codes(vt.alt)
    alt_empty = np.array([len(s) == 0 for s in vt.alt], bool)
    daf = vt.gt.sum(axis=1, dtype=np.int64)
    biallelic = ~(vt.gt > 1).any(axis=1)
    n_hap = vt.gt.shape[1]
    return ref1, alt1, alt_empty, daf, biallelic, n_hap


def _cursor_index(rec_pos: np.ndarray, qpos: np.ndarray):
    """Final cursor record per query (nondecreasing qpos): the cursor
    starts at record 0 (read at chromosome open) and advances while
    bp_rec < bp_query, stopping at the first record >= query or EOF.
    Returns (idx_clipped, exists) where exists == record at the query
    position."""
    n = rec_pos.shape[0]
    if n == 0:
        return np.zeros(qpos.shape, np.int64), np.zeros(qpos.shape, bool)
    s = np.searchsorted(rec_pos, qpos, side="left")
    idx = np.minimum(np.maximum.accumulate(np.maximum(s, 0)), n - 1)
    exists = (s < n) & (rec_pos[idx] == qpos)
    return idx, exists


def join_vcf_split(
    chrom_names: list[str],
    mut_files: list[str],
    target_files: list[str],
    tmask_files: list[str] | None,
    ref_genome_files: list[str] | None,
    rng,
    age: float = 0.0,
    ref_age: float = 0.0,
    mc_hists: tuple | None = None,
):
    """parse_vcf equivalent (coal.cpp:594-904): ONE BCF holding >=1
    diploid genome; at every site the haplotypes are split by index
    parity into a pseudo "target" half (parity == choose, one fresh
    ``dist_unif(rng) < 0.5`` draw per allele-matching record visit) and
    a "reference" half.

    Exact semantics:
    - row filters: flipped==0, one branch, age_begin<age_end, valid
      alleles, target mask 'P' (NO anc!=der check in this parser);
    - cursor: record at chromosome open already read; advance while
      bp < bp_mut; exists iff final record pos == bp_mut (re-matchable);
    - case FIXED (REF == derived string, no ALT): draw choose; use only
      if biallelic and both half genotype sums are exactly 0; then
      DAF_target=N_target, DAF_ref=N_ref (coal.cpp:706-744);
    - case SEG (REF/ALT == anc/der straight or flipped): draw choose;
      use iff biallelic; half sums (missing GT counts -1), flip
      complements both halves (coal.cpp:746-797);
    - other existing records: no draw, reject;
    - absent sites: ref-genome base == derived ⇒ DAF_target=N_target,
      DAF_ref=N_ref using the values CARRIED from the last fixed/seg
      visit (N_target starts at the full haplotype count per chromosome
      open, N_ref starts *uninitialised* — we treat it as 0, rejecting
      leading absent sites via the DAF_ref==0 rule; coal.cpp:798-815);
    - DAF_ref == 0 rejects; weights DAF_target*DAF_ref/N_ref and
      (N_target-DAF_target)*DAF_ref/N_ref with the carried N values.

    The choose draws interleave with the per-site age sampling in the
    reference's single mt19937 stream, so when ``mc_hists`` (four
    preallocated [>=num_blocks, nbins] arrays) is given, each used site
    is binned immediately via :func:`mc_bin_site` — bit-exact replay.
    Otherwise chooses are drawn per visit (batched — equivalent, since
    no other draw interleaves) and binning happens later analytically.
    """
    from colate_tpu_torch.pipeline.binning import mc_bin_site

    age = 0.0  # forced (coal.cpp:597-598)
    ref_age = 0.0

    out_ab, out_ae, out_ws, out_wn, out_blk = [], [], [], [], []
    out_wsm, out_wnm = [], []
    block_offset = 0
    n_ref_carry = 0  # stands in for the reference's uninitialised N_ref

    for ci, chrom in enumerate(chrom_names):
        print(f"parsing CHR: {ci + 1} / {len(chrom_names)}", file=sys.stderr)
        mt = MutTable.read(mut_files[ci])
        tgt = read_vcf(target_files[ci])
        tmask = read_mask(tmask_files[ci]) if tmask_files else None
        genome = (
            np.frombuffer(read_fasta(ref_genome_files[ci]).encode(), np.uint8)
            if ref_genome_files
            else None
        )

        anc_c, der_c, valid = allele_codes(mt)
        keep = (
            (mt.flipped == 0)
            & (mt.num_branches == 1)
            & (mt.age_begin < mt.age_end)
            & (mt.age_end >= age)
            & valid
        )
        if tmask is not None:
            keep &= _mask_pass(tmask, mt.pos)
        rows = np.nonzero(keep)[0]
        pos = mt.pos[rows].astype(np.int64)
        anc = anc_c[rows]
        der = der_c[rows]

        if genome is not None and genome.shape[0]:
            gidx = np.clip(pos - 1, 0, genome.shape[0] - 1)
            gbase = np.where(
                (pos - 1 >= 0) & (pos - 1 < genome.shape[0]), genome[gidx], 0
            )
        else:
            gbase = np.zeros(pos.shape, np.uint8)

        ref1, alt1, alt_empty, _, bi, n_hap = _vcf_columns(tgt)
        # per-record parity-half genotype sums (haplotype k = ploidy*i+j)
        s_even = tgt.gt[:, 0::2].sum(axis=1, dtype=np.int64)
        s_odd = tgt.gt[:, 1::2].sum(axis=1, dtype=np.int64)
        c_even = (n_hap + 1) // 2
        c_odd = n_hap // 2

        tidx, texists = _cursor_index(tgt.pos, pos)
        r1 = ref1[tidx]
        a1 = alt1[tidx]
        case_fixed = texists & alt_empty[tidx] & (r1 == der)
        case_seg = (
            texists
            & ~alt_empty[tidx]
            & (((r1 == anc) & (a1 == der)) | ((r1 == der) & (a1 == anc)))
        )
        flip_seg = texists & ~alt_empty[tidx] & (r1 == der) & (a1 == anc)
        draws = case_fixed | case_seg
        absent_cand = ~texists & (gbase == der) if ref_genome_files else np.zeros(
            pos.shape, bool
        )
        s0 = s_even[tidx]
        s1 = s_odd[tidx]
        is_bi = bi[tidx]

        n_tgt_carry = n_hap  # reset at chromosome open (coal.cpp:642-644)

        if mc_hists is not None:
            # ---- sequential replay: chooses interleave with age draws ----
            if hasattr(mc_hists, "ensure") and pos.size:
                mc_hists.ensure(
                    block_offset
                    + int(max((int(pos.max()) - 1) // NUM_BASES_PER_BLOCK, 0))
                    + 1
                )
            shared, notshared, shared_emp, notshared_emp = mc_hists
            interesting = np.nonzero(draws | absent_cand)[0]
            last_blk = 0
            for i in interesting:
                if draws[i]:
                    choose = 1 if rng.uniform01(1)[0] < 0.5 else 0
                    st, sr = (s1[i], s0[i]) if choose else (s0[i], s1[i])
                    n_t = c_odd if choose else c_even
                    n_r = c_even if choose else c_odd
                    n_tgt_carry, n_ref_carry = n_t, n_r
                    if not is_bi[i]:
                        continue
                    if case_fixed[i]:
                        if st != 0 or sr != 0:
                            continue
                        daf_t, daf_r = n_t, n_r
                    else:
                        daf_t, daf_r = int(st), int(sr)
                        if flip_seg[i]:
                            daf_t, daf_r = n_t - daf_t, n_r - daf_r
                else:
                    daf_t, daf_r = n_tgt_carry, n_ref_carry
                    n_t, n_r = n_tgt_carry, n_ref_carry
                if daf_r == 0:
                    continue
                bp = int(pos[i])
                blk = max((bp - 1) // NUM_BASES_PER_BLOCK, 0) + block_offset
                mrow = rows[i]
                ab = max(mt.age_begin[mrow], ref_age)
                ae = mt.age_end[mrow]
                ws = daf_t * daf_r / float(n_r)
                wn = (n_t - daf_t) * daf_r / float(n_r)
                ws_mc = daf_t * daf_r / (100.0 * n_r)
                wn_mc = (n_t - daf_t) * daf_r / (100.0 * n_r)
                out_ab.append(np.array([ab]))
                out_ae.append(np.array([ae]))
                out_ws.append(np.array([ws]))
                out_wn.append(np.array([wn]))
                out_wsm.append(np.array([ws_mc]))
                out_wnm.append(np.array([wn_mc]))
                out_blk.append(np.array([blk], np.int64))
                mc_bin_site(
                    shared, notshared, shared_emp, notshared_emp,
                    blk, ab, ae, ws, wn, rng, age,
                    ws_mc=ws_mc, wn_mc=wn_mc,
                )
                last_blk = blk - block_offset
        else:
            # ---- vectorised: batch the choose draws ----
            ev = np.nonzero(draws)[0]
            chooses = (rng.uniform01(ev.shape[0]) < 0.5).astype(np.int64)
            st = np.where(chooses == 1, s1[ev], s0[ev])
            sr = np.where(chooses == 1, s0[ev], s1[ev])
            n_t_ev = np.where(chooses == 1, c_odd, c_even)
            n_r_ev = np.where(chooses == 1, c_even, c_odd)
            daf_t_ev = np.where(
                flip_seg[ev], n_t_ev - st, np.where(case_fixed[ev], n_t_ev, st)
            )
            daf_r_ev = np.where(
                flip_seg[ev], n_r_ev - sr, np.where(case_fixed[ev], n_r_ev, sr)
            )
            use_ev = is_bi[ev] & (
                ~case_fixed[ev] | ((st == 0) & (sr == 0))
            )
            # carry for absent rows: last event before the row (or opener)
            j = np.searchsorted(ev, np.arange(pos.shape[0]), side="left") - 1
            carry_nt = np.where(j >= 0, n_t_ev[np.maximum(j, 0)], n_tgt_carry)
            carry_nr = np.where(
                j >= 0, n_r_ev[np.maximum(j, 0)], n_ref_carry
            )

            use = np.zeros(pos.shape, bool)
            daf_t = np.zeros(pos.shape, np.int64)
            daf_r = np.zeros(pos.shape, np.int64)
            n_t_all = np.ones(pos.shape, np.int64)
            use[ev] = use_ev
            daf_t[ev] = daf_t_ev
            daf_r[ev] = daf_r_ev
            n_t_all[ev] = n_t_ev
            n_r_all = np.ones(pos.shape, np.int64)
            n_r_all[ev] = n_r_ev
            use |= absent_cand
            daf_t = np.where(absent_cand, carry_nt, daf_t)
            daf_r = np.where(absent_cand, carry_nr, daf_r)
            n_t_all = np.where(absent_cand, carry_nt, n_t_all)
            n_r_all = np.where(absent_cand, carry_nr, n_r_all)
            use &= daf_r != 0
            tsel = np.nonzero(use)[0]
            # carry across chromosomes: last event of this chromosome
            if ev.size:
                n_ref_carry = int(n_r_ev[-1])

            if tsel.size:
                mrows = rows[tsel]
                dt = daf_t[tsel].astype(np.float64)
                dr = daf_r[tsel].astype(np.float64)
                nr = n_r_all[tsel].astype(np.float64)
                nt = n_t_all[tsel].astype(np.float64)
                ab = np.maximum(mt.age_begin[mrows], ref_age)
                ae = mt.age_end[mrows]
                bp_used = mt.pos[mrows].astype(np.int64)
                blk = np.maximum(
                    (bp_used - 1) // NUM_BASES_PER_BLOCK, 0
                ).astype(np.int64)
                out_ab.append(ab)
                out_ae.append(ae)
                out_ws.append(dt * dr / nr)
                out_wn.append((nt - dt) * dr / nr)
                out_wsm.append(dt * dr / (100.0 * nr))
                out_wnm.append((nt - dt) * dr / (100.0 * nr))
                out_blk.append(blk + block_offset)
                last_blk = int(blk[-1])
            else:
                last_blk = 0
        block_offset += last_blk + 1

    if out_ab:
        return JoinedSites(
            age_begin=np.concatenate(out_ab),
            age_end=np.concatenate(out_ae),
            w_shared=np.concatenate(out_ws),
            w_notshared=np.concatenate(out_wn),
            block_id=np.concatenate(out_blk).astype(np.int32),
            num_blocks=block_offset,
            w_shared_mc=np.concatenate(out_wsm),
            w_notshared_mc=np.concatenate(out_wnm),
        )
    return JoinedSites(
        age_begin=np.zeros(0),
        age_end=np.zeros(0),
        w_shared=np.zeros(0),
        w_notshared=np.zeros(0),
        block_id=np.zeros(0, np.int32),
        num_blocks=block_offset,
    )


def join_vcfvcf(
    chrom_names: list[str],
    mut_files: list[str],
    target_files: list[str],
    ref_files: list[str],
    tmask_files: list[str] | None,
    rmask_files: list[str] | None,
    ref_genome_files: list[str] | None,
    age: float = 0.0,
    ref_age: float = 0.0,
) -> JoinedSites:
    age = 0.0  # forced (coal.cpp:908-909)
    ref_age = 0.0

    out_ab, out_ae, out_ws, out_wn, out_blk = [], [], [], [], []
    out_wsm, out_wnm = [], []
    block_offset = 0

    for ci, chrom in enumerate(chrom_names):
        print(f"parsing CHR: {ci + 1} / {len(chrom_names)}", file=sys.stderr)
        mt = MutTable.read(mut_files[ci])
        tgt = read_vcf(target_files[ci])
        ref = read_vcf(ref_files[ci])
        tmask = read_mask(tmask_files[ci]) if tmask_files else None
        rmask = read_mask(rmask_files[ci]) if rmask_files else None
        genome = (
            np.frombuffer(read_fasta(ref_genome_files[ci]).encode(), np.uint8)
            if ref_genome_files
            else None
        )

        anc_c, der_c, valid = allele_codes(mt)
        keep = (
            (mt.flipped == 0)
            & (mt.num_branches == 1)
            & (mt.age_begin < mt.age_end)
            & (mt.age_end >= age)
            & valid
            & (anc_c != der_c)  # coal.cpp:996
        )
        if tmask is not None:
            keep &= _mask_pass(tmask, mt.pos)
        if rmask is not None:
            keep &= _mask_pass(rmask, mt.pos)
        rows = np.nonzero(keep)[0]
        pos = mt.pos[rows].astype(np.int64)
        anc = anc_c[rows]
        der = der_c[rows]

        # genome base at bp-1 (0 when out of range / no genome)
        if genome is not None and genome.shape[0]:
            gidx = np.clip(pos - 1, 0, genome.shape[0] - 1)
            gbase = np.where(
                (pos - 1 >= 0) & (pos - 1 < genome.shape[0]), genome[gidx], 0
            )
        else:
            gbase = np.zeros(pos.shape, np.uint8)

        # ---- reference stream ----
        r_ref1, r_alt1, _, r_daf, r_bi, n_ref = _vcf_columns(ref)
        ridx, rexists = _cursor_index(ref.pos, pos)
        straight = rexists & (r_ref1[ridx] == anc) & (r_alt1[ridx] == der)
        flip = rexists & (r_ref1[ridx] == der) & (r_alt1[ridx] == anc)
        r_use = np.ones(pos.shape, bool)
        daf_ref = np.zeros(pos.shape, np.int64)
        m = straight | flip
        r_use &= ~rexists | (m & r_bi[ridx])
        daf_ref = np.where(
            rexists & m, np.where(flip, n_ref - r_daf[ridx], r_daf[ridx]), 0
        )
        if ref_genome_files:
            absent_ok = ~rexists & (gbase == der)
            daf_ref = np.where(absent_ok, n_ref, daf_ref)
            r_use &= rexists | absent_ok
        else:
            r_use &= rexists
        r_use &= daf_ref != 0  # only ==0 rejects (coal.cpp:1062)
        rsel = np.nonzero(r_use)[0]

        # ---- target stream (only ref-surviving rows advance) ----
        t_ref1, t_alt1, t_alt_empty, t_daf, t_bi, n_tgt = _vcf_columns(tgt)
        tpos = pos[rsel]
        tanc = anc[rsel]
        tder = der[rsel]
        tidx, texists = _cursor_index(tgt.pos, tpos)
        ref1 = t_ref1[tidx]
        alt1 = t_alt1[tidx]
        fixed_for_ref = texists & t_alt_empty[tidx]
        acc_fixed = fixed_for_ref & ((ref1 == tanc) | (ref1 == tder))
        flip_fixed = fixed_for_ref & (ref1 == tder)
        acc_seg = (
            texists
            & ~t_alt_empty[tidx]
            & (((ref1 == tanc) & (alt1 == tder)) | ((ref1 == tder) & (alt1 == tanc)))
        )
        flip_seg = texists & ~t_alt_empty[tidx] & (ref1 == tder) & (alt1 == tanc)
        accept = acc_fixed | acc_seg
        daf_t = np.where(accept, t_daf[tidx], 0)
        accept &= t_bi[tidx]
        accept &= ~(fixed_for_ref & (daf_t != 0))
        t_flip = flip_fixed | flip_seg
        daf_t = np.where(t_flip, n_tgt - daf_t, daf_t)
        t_use = np.where(texists, accept, False)
        if ref_genome_files:
            gb = gbase[rsel]
            t_use = np.where(
                ~texists, (gb == tder) | (gb == tanc), t_use
            )
            daf_t = np.where(~texists & (gb == tder), n_tgt, daf_t)
            daf_t = np.where(~texists & (gb != tder) & (gb == tanc), 0, daf_t)
        tsel = rsel[t_use]

        if tsel.size:
            mrows = rows[tsel]
            daf_r = daf_ref[tsel].astype(np.float64)
            dt = daf_t[t_use].astype(np.float64)
            ab = np.maximum(mt.age_begin[mrows], ref_age)
            ae = mt.age_end[mrows]
            bp_used = mt.pos[mrows].astype(np.int64)
            blk = np.maximum((bp_used - 1) // NUM_BASES_PER_BLOCK, 0).astype(np.int64)
            out_ab.append(ab)
            out_ae.append(ae)
            out_ws.append(dt * daf_r / float(n_ref))
            out_wn.append((float(n_tgt) - dt) * daf_r / float(n_ref))
            # per-draw grouping x*DAF_ref/(100.0*N_ref) (coal.cpp:1186-1187)
            out_wsm.append(dt * daf_r / (100.0 * n_ref))
            out_wnm.append((float(n_tgt) - dt) * daf_r / (100.0 * n_ref))
            out_blk.append(blk + block_offset)
            last_blk = int(blk[-1])
        else:
            last_blk = 0
        block_offset += last_blk + 1

    if out_ab:
        return JoinedSites(
            age_begin=np.concatenate(out_ab),
            age_end=np.concatenate(out_ae),
            w_shared=np.concatenate(out_ws),
            w_notshared=np.concatenate(out_wn),
            block_id=np.concatenate(out_blk).astype(np.int32),
            num_blocks=block_offset,
            w_shared_mc=np.concatenate(out_wsm),
            w_notshared_mc=np.concatenate(out_wnm),
        )
    return JoinedSites(
        age_begin=np.zeros(0),
        age_end=np.zeros(0),
        w_shared=np.zeros(0),
        w_notshared=np.zeros(0),
        block_id=np.zeros(0, np.int32),
        num_blocks=block_offset,
    )
