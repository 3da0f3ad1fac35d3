"""Model-wide constants.

Mirrors the reference's compile-time defines:
  - KMER_LENGTH / NUM_OF_KMERS: reference inc/emissionMatrix.h:4-5
  - MODEL_PARAMS (level_mean, level_sd, noise_mean, noise_sd, noise_lambda):
    reference inc/stateMachine.h:17
  - NB_EVENT_PARAMS (mean, noise, duration): reference inc/nanopore.h:4
  - PAIR_ALIGNMENT_PROB_1 (posterior quantization): reference inc/pairwiseAligner.h:26
  - LOG_ZERO: reference inc/pairwiseAligner.h:188

Copied from ``cpecan_signal_tpu/constants.py`` with its imports made relative
to the port, so that the port imports nothing of the JAX package.
"""

KMER_LENGTH = 6
SYMBOL_NUMBER_NO_N = 4
NUM_OF_KMERS = SYMBOL_NUMBER_NO_N**KMER_LENGTH  # 4096
# Sentinel rank used for any k-mer containing a non-ACGT character.  The
# reference computes some rank > NUM_OF_KMERS for those (stateMachine.c:104-139);
# every consumer only tests `> NUM_OF_KMERS`, so a single sentinel is equivalent.
KMER_SENTINEL = NUM_OF_KMERS + 1

MODEL_PARAMS = 5
NB_EVENT_PARAMS = 3
N_SKIP_BINS = 30          # vanilla/echelon kmer-skip bins (stateMachine.c:276-294)
SKIP_BIN_WIDTH_PA = 0.5   # pA per skip bin (stateMachine.c:414)

PAIR_ALIGNMENT_PROB_1 = 10_000_000
LOG_ZERO = float("-inf")

# Expanded epigenetic alphabet used by the HDP build path
# (nanopore_hdp.c:875-908; E = 5-methyl-C, O = 5-hydroxymethyl-C).
EPIGENETIC_ALPHABET = "ACEGOT"
