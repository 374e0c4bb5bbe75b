"""Host copies of kaldi_tpu.fst (pure Python): the WFST algebra, L, H,
N-phone context and HCLG construction, per-utterance training graphs, the
flat-array pipeline over the native graph ops, text I/O, the special
(phi / rho) compositions and factoring."""

from kaldi_tpu_torch.fst.fst import Fst, EPS, SymbolTable
from kaldi_tpu_torch.fst.compose import compose, table_compose
from kaldi_tpu_torch.fst.determinize import determinize_star
from kaldi_tpu_torch.fst.minimize import minimize_encoded
from kaldi_tpu_torch.fst.epsilon import (remove_eps_local, remove_symbols,
                                         rm_epsilon)
