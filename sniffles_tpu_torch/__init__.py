"""
sniffles-tpu, PyTorch/CUDA port on an NVIDIA Hopper card: the four run
modes of the JAX package, single-sample calling (call_sample, .bam -> VCF
and .snf), force calling (genotype_vcf, .bam and a VCF of targets ->
VCF), the multi-sample combine (.snf inputs -> multi-sample VCF, plain or
.vcf.gz) and its population SNF.

The JAX package `sniffles_tpu` beside this one is the reference; this
package keeps its module names, CLI flags and SNF/VCF formats, so that a
reader finds each counterpart and both packages read each other's SNF
files. Device work runs on `cuda` unless SNIFFLES_TPU_FORCE_CPU=1 asks
for the CPU (where every kernel wrapper takes its plain PyTorch version).
"""

VERSION = "sniffles-tpu"
# Feature lineage 2.8 (reference parity target), our own build counter
# after the '+'. The leading component must compare >= "2.5.3" as a
# string: both this tool and reference Sniffles2 auto re-QC SNF files
# whose recorded build sorts below that (reference: snf.py:68-81).
BUILD = "2.8.0+tpu.0.1.0"
SNF_VERSION = "S2_rc4"  # SNF layout compatible with reference snf.py

__version__ = BUILD
