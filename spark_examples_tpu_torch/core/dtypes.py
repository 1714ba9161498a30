"""Genotype dtype policy.

A genotype block is an ``(n_samples, block_variants)`` array of
alt-allele dosages: 0, 1, 2 alternate alleles, or ``MISSING`` for a
no-call, stored as int8 on host and device.
"""

from __future__ import annotations

import numpy as np

# Host/device storage dtype for genotype dosage blocks.
GENOTYPE_DTYPE = np.int8

MISSING = -1  # sentinel dosage for a missing genotype call
