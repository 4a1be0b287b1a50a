"""Carry codec state between phyngsc_tpu and the port.

In this codec the state is the code tables: phyngsc_tpu's QualityTables and
DnaPlan hold numpy arrays, so conversion copies the arrays into the port's
dataclasses. Tests use it to feed both encoders and decoders the same
tables.
"""

from __future__ import annotations

import numpy as np

from phyngsc_tpu_torch.models import dna, quality


def quality_tables(src) -> quality.QualityTables:
    """Any object with lens / codes / singletons arrays -> port QualityTables."""
    return quality.QualityTables(lens=np.array(src.lens, np.uint8),
                                 codes=np.array(src.codes, np.uint32),
                                 singletons=np.array(src.singletons, np.int32))


def dna_plan(src) -> dna.DnaPlan:
    """Any object with mode / lens_tab / codes_tab / singleton -> port DnaPlan."""
    return dna.DnaPlan(mode=int(src.mode),
                       lens_tab=np.array(src.lens_tab, np.uint8),
                       codes_tab=np.array(src.codes_tab, np.uint32),
                       singleton=int(src.singleton))
