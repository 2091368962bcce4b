"""Mode ``preprocess_mut``: augment a Relate .mut with fixed mutations.

Reference: coal/coal.cpp:3866-4146.  Walks the reference BCF against the
.anc/.mut stream and emits a new .mut containing:

- *gap* fixed SNPs: positions between consecutive BCF records where the
  reference genome differs from the ancestral genome (mask=='P', both
  bases valid, tree TMRCA <= outgroup age): branch=[root],
  ages [tmrca, outgroup_tmrca], freq=[N]  — NOTE the mask/genome
  indexing here is 0-based bp (not the bp-1 of other modes);
- *segregating* SNPs present in both BCF (0<DAF<N, biallelic,
  allele-matched straight/flipped) and .mut: copied with freq=[DAF];
- *fixed at BCF sites* (DAF==0 or N): classified against ref/anc
  genomes and REF/ALT (coal.cpp:4066-4123).

Replicated quirk: a rejected fixed-site row still updates the previous
row's dist before being discarded (coal.cpp:4109-4121: the decrement
happens after the dist write), so a trailing rejected site leaves the
previous row's dist pointing at the rejected position.

Copied from colate_tpu/models/preprocess_mut.py with its imports rewritten.
"""

from __future__ import annotations

import sys

import numpy as np

from colate_tpu_torch.formats.anc import AncFile, node_ages
from colate_tpu_torch.formats.fasta import read_fasta
from colate_tpu_torch.formats.mut import MutTable
from colate_tpu_torch.formats.vcf import read_vcf

_VALID = set("ACGT01")


def run_preprocess_mut(args) -> int:
    need = [args.anc, args.mut, args.reference_bcf, args.ref_genome,
            args.anc_genome, args.mask, args.output]
    if any(x is None for x in need):
        print(
            "Needed: anc, mut, reference_bcf, ref_genome, anc_genome, mask, output.",
            file=sys.stderr,
        )
        return 2
    ypg = float(np.float32(args.years_per_gen)) if args.years_per_gen else 28.0
    outgroup_age = (
        float(np.float32(args.outgroup_tmrca)) / ypg
        if args.outgroup_tmrca
        else 10e6 / ypg
    )

    ref_genome = read_fasta(args.ref_genome)
    anc_genome = read_fasta(args.anc_genome)
    mask = read_fasta(args.mask)
    vt = read_vcf(args.reference_bcf)
    anc = AncFile.read(args.anc, columns="tree")
    mt = MutTable.read(args.mut)
    L_ref = len(mt)
    root = 2 * anc.n_hap - 2
    tmrca_per_tree = node_ages(anc)[:, root].astype(np.float64)  # f32 values

    rows: list[dict] = []

    def push(pos, tree, age_begin, age_end, mtype, freq, base=None):
        if rows:
            rows[-1]["dist"] = pos - rows[-1]["pos"]
        row = dict(
            snp_id=len(rows), pos=pos, dist=0, rs_id="", tree=tree,
            branch=[root], not_mapping=0, flipped=0,
            age_begin=age_begin, age_end=age_end, mtype=mtype,
            rest=f"NA;NA;{freq};",
        )
        if base is not None:
            row.update(base)
        rows.append(row)

    def pop_rejected():
        rows.pop()
        for i, r in enumerate(rows):
            r["snp_id"] = i

    # mut cursor
    snp_ref = 0
    tree_count = int(mt.tree[0]) if L_ref else 0
    tmrca = float(tmrca_per_tree[min(tree_count, anc.num_trees - 1)])

    bp = -1
    n_hap = vt.gt.shape[1]
    for k in range(len(vt)):
        gt_row = vt.gt[k].astype(np.int64)
        N = gt_row.shape[0]
        biallelic = not np.any(gt_row > 1)
        DAF = int(gt_row.sum())
        bp_prev = bp
        bp = int(vt.pos[k]) - 1  # 0-based like rec->pos

        # gap scan (coal.cpp:3950-3992); 0-based genome/mask indexing
        for bp_tmp in range(bp_prev + 1, bp):
            if (
                bp_tmp < len(mask)
                and bp_tmp < len(anc_genome)
                and bp_tmp < len(ref_genome)
                and mask[bp_tmp] == "P"
                and ref_genome[bp_tmp] != anc_genome[bp_tmp]
                and tmrca <= outgroup_age
                and ref_genome[bp_tmp] in _VALID
                and anc_genome[bp_tmp] in _VALID
            ):
                push(
                    bp_tmp + 1, tree_count,
                    float(np.float32(tmrca)), float(np.float32(outgroup_age)),
                    f"{anc_genome[bp_tmp]}/{ref_genome[bp_tmp]}", N,
                )

        if not biallelic:
            continue
        # advance mut cursor to first row with pos >= bp+1
        if snp_ref < L_ref:
            while mt.pos[snp_ref] < bp + 1:
                snp_ref += 1
                if snp_ref == L_ref:
                    snp_ref -= 1
                    break
        cur_tree = int(mt.tree[snp_ref])
        if tree_count < cur_tree:
            tree_count = cur_tree
            tmrca = float(tmrca_per_tree[min(tree_count, anc.num_trees - 1)])

        vcf_ref = vt.ref[k]
        vcf_alt = vt.alt[k]
        if int(mt.pos[snp_ref]) == bp + 1 and 0 < DAF < N:
            r = snp_ref
            if mt.flipped[r] == 0 and mt.num_branches[r] == 1:
                mtype = mt.mutation_type[r]
                j = mtype.find("/")
                ancestral = mtype[:j] if j >= 0 else mtype
                derived = mtype[j + 1 :] if j >= 0 else ""
                if (ancestral == vcf_ref and derived == vcf_alt) or (
                    derived == vcf_ref and ancestral == vcf_alt
                ):
                    daf = N - DAF if (derived == vcf_ref and ancestral == vcf_alt) else DAF
                    if mt.age_end[r] > 0:
                        push(
                            bp + 1, tree_count,
                            mt.age_begin[r], mt.age_end[r], mtype, daf,
                            base=dict(
                                rs_id=mt.rs_id[r],
                                branch=mt.branch[r],
                                not_mapping=0,
                                flipped=0,
                                # the copy keeps the input row's dist; it is
                                # only overwritten when a later row is pushed
                                # (coal.cpp:4042 copies *it_mut wholesale)
                                dist=int(mt.dist[r]),
                            ),
                        )
        elif DAF in (0, N):
            if (
                tmrca <= outgroup_age
                and bp < len(ref_genome)
                and bp < len(anc_genome)
                and bp < len(mask)
                and len(vcf_ref) == 1
                and len(vcf_alt) == 1
                and mask[bp] == "P"
                and ref_genome[bp] in _VALID
                and anc_genome[bp] in _VALID
            ):
                reject = False
                ancestral = derived = ""
                if DAF == N:
                    if (
                        anc_genome[bp] == ref_genome[bp]
                        and vcf_ref == ref_genome[bp]
                        and vcf_alt != anc_genome[bp]
                    ):
                        ancestral, derived = anc_genome[bp], vcf_alt
                    else:
                        reject = True
                else:
                    if (
                        ref_genome[bp] != anc_genome[bp]
                        and vcf_ref == ref_genome[bp]
                        and vcf_alt == anc_genome[bp]
                    ):
                        ancestral, derived = anc_genome[bp], ref_genome[bp]
                    else:
                        reject = True
                push(
                    bp + 1, tree_count,
                    float(np.float32(tmrca)), float(np.float32(outgroup_age)),
                    f"{ancestral}/{derived}", N,
                )
                if reject:
                    pop_rejected()

    _dump(rows, args.output)
    print(f"preprocess_mut: {len(rows)} SNPs -> {args.output}", file=sys.stderr)
    return 0


def _dump(rows: list[dict], path: str) -> None:
    header = (
        "snp;pos_of_snp;dist;rs-id;tree_index;branch_indices;is_not_mapping;"
        "is_flipped;age_begin;age_end;ancestral_allele/alternative_allele;"
        "upstream_allele;downstream_allele;"
    )
    with open(path, "w") as fh:
        fh.write(header + "\n")
        for r in rows:
            br = " ".join(str(b) for b in r["branch"])
            nm = 1 if len(r["branch"]) > 1 else 0
            fh.write(
                f"{r['snp_id']};{r['pos']};{r['dist']};{r['rs_id']};{r['tree']};"
                f"{br};{nm};{r['flipped']};{r['age_begin']:g};{r['age_end']:g};"
                f"{r['mtype']};{r['rest']}\n"
            )
