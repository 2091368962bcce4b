"""Readers/writers of the files the port's modes read and write, copied
from colate_tpu/formats: ``.mut`` (mut.py), ``.colate.in`` (colate_in.py),
``.coal`` (coal.py), ``.colate_mat`` (colate_mat.py), fasta masks
(fasta.py), ``.anc`` (anc.py), poplabels (sample.py), recombination maps
(gmap.py), VCF/BCF (vcf.py) and BAM (bam.py)."""
