"""Datasets: PTB-XL labels and splits, the combined-HDF5 corpus (h5py,
imported when used), the synthetic corpora (numpy, and on the device).  The
denoise export job is ``data.export`` (import it; it is not re-exported)."""
from .datasets import (EcgDataset, PtbxlSplits, compute_train_stats, export_ptbxl_labels,
                       get_ptbxl_splits, labels_to_multi_hot, load_ptbxl_from_export,
                       parse_scp_codes, split_by_strat_fold, synth_ecg, synth_ptbxl,
                       synth_ptbxl_device, write_combined_hdf5, write_labels_csv)

__all__ = ['EcgDataset', 'PtbxlSplits', 'compute_train_stats', 'export_ptbxl_labels',
           'get_ptbxl_splits', 'labels_to_multi_hot', 'load_ptbxl_from_export',
           'parse_scp_codes', 'split_by_strat_fold', 'synth_ecg', 'synth_ptbxl',
           'synth_ptbxl_device', 'write_combined_hdf5', 'write_labels_csv']
