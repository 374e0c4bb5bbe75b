"""Keyword search: lattice factor index, search, TWV scoring, proxies.

(ref: src/kws — lattice-to-kws-index over a (prob, t_start, t_end)
 lexicographic semiring kws/kaldi-kws.h:44-46, factor handling
 kws/kws-functions.h:89-97, ATWV kws/kws-scoring.h:188-236.)

The port's copy of kaldi_tpu/kws/__init__.py (host code), carried verbatim so
the port imports nothing of kaldi_tpu; tests hold the two equal.
"""

from kaldi_tpu_torch.kws.index import (KwsIndex, lattice_to_kws_index,
                                       search_index, save_kws_index,
                                       load_kws_index, union_kws_indexes)
from kaldi_tpu_torch.kws.scoring import TwvOptions, compute_twv, align_hits
from kaldi_tpu_torch.kws.proxy import generate_proxy_keywords

__all__ = [
    "KwsIndex", "lattice_to_kws_index", "search_index",
    "TwvOptions", "compute_twv", "align_hits",
    "generate_proxy_keywords",
]
