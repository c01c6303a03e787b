"""Host-side utilities: logging, argument validation, visualization,
reporting, the ECG domain helpers, formatting and profiling, and the port's
tracing (``tracing``: spans and the training step's phase marks)."""
from .logging import TbWriter, get_logger, pretty_log_dict, pretty_single
from .viz import barplot, plot_1d, plot_ecg, save_fig, set_color_bar, vals2colors
from .rollout import EcgVitVisualizer, attention_rollout, top_predictions
from .auc_plot import PtbxlAucVisualizer
from .ecg_domain import correct_peaks, detect_rpeaks, fit_power_law, r2, refine_rpeak
from .misc import fmt_time, profile_runtime, readable_int
from .tracing import StepTimer, device_trace

__all__ = [
    'TbWriter', 'get_logger', 'pretty_log_dict', 'pretty_single',
    'barplot', 'plot_1d', 'plot_ecg', 'save_fig', 'set_color_bar', 'vals2colors',
    'EcgVitVisualizer', 'attention_rollout', 'top_predictions',
    'PtbxlAucVisualizer',
    'correct_peaks', 'detect_rpeaks', 'fit_power_law', 'r2', 'refine_rpeak',
    'StepTimer', 'device_trace', 'fmt_time', 'profile_runtime', 'readable_int',
]
