"""Datasets: PTB-XL labels and splits, the synthetic corpus (numpy).  The
denoise export job is ``data.export`` (import it; it is not re-exported)."""
from .datasets import (PtbxlSplits, compute_train_stats, get_ptbxl_splits,
                       labels_to_multi_hot, parse_scp_codes, split_by_strat_fold,
                       synth_ecg, synth_ptbxl)

__all__ = ['PtbxlSplits', 'compute_train_stats', 'get_ptbxl_splits',
           'labels_to_multi_hot', 'parse_scp_codes', 'split_by_strat_fold',
           'synth_ecg', 'synth_ptbxl']
