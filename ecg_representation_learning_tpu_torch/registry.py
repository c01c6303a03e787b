"""PTB-XL code tables, the corpus table, grid constants and normalization
statistics.

A copy of the tables in the JAX package's ``registry.py`` (the port imports
nothing of that package): the 71-code id order, the per-code descriptions,
the taxonomy (aspects, the diagnostic class -> subclass -> code map, the
subclass descriptions), the public 12-lead corpora (``DatasetMeta``,
``DATASETS``, the export and WFDB lists), the 250 Hz 12-lead grid and lead
order, the Zheng denoise constants, the train-split per-lead statistics and
the ``config('a.b.c')`` accessor.  ``tests/test_torch_imports.py``,
``tests/test_torch_serving.py``, ``tests/test_torch_ingest.py`` and
``tests/test_torch_utils.py`` hold the copy equal to the original.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

# id -> SCP code, 71 entries (order of scp_statements.csv restricted to the
# diagnostic/form/rhythm aspects)
PTBXL_ID2CODE: Tuple[str, ...] = (
    'NDT', 'NST_', 'DIG', 'LNGQT', 'NORM', 'IMI', 'ASMI', 'LVH', 'LAFB', 'ISC_',
    'IRBBB', '1AVB', 'IVCD', 'ISCAL', 'CRBBB', 'CLBBB', 'ILMI', 'LAO/LAE', 'AMI', 'ALMI',
    'ISCIN', 'INJAS', 'LMI', 'ISCIL', 'LPFB', 'ISCAS', 'INJAL', 'ISCLA', 'RVH', 'ANEUR',
    'RAO/RAE', 'EL', 'WPW', 'ILBBB', 'IPLMI', 'ISCAN', 'IPMI', 'SEHYP', 'INJIN', 'INJLA',
    'PMI', '3AVB', 'INJIL', '2AVB', 'ABQRS', 'PVC', 'STD_', 'VCLVH', 'QWAVE', 'LOWT',
    'NT_', 'PAC', 'LPR', 'INVT', 'LVOLT', 'HVOLT', 'TAB_', 'STE_', 'PRC(S)', 'SR',
    'AFIB', 'STACH', 'SARRH', 'SBRAD', 'PACE', 'SVARR', 'BIGU', 'AFLT', 'SVTAC', 'PSVT',
    'TRIGU',
)
PTBXL_CODE2ID: Dict[str, int] = {c: i for i, c in enumerate(PTBXL_ID2CODE)}
PTBXL_N_CLASS = len(PTBXL_ID2CODE)
assert PTBXL_N_CLASS == 71

# Aspect membership (reference config.json form-codes / rhythm-codes; codes may
# belong to several aspects, e.g. NDT is diagnostic+form)
PTBXL_FORM_CODES: Tuple[str, ...] = (
    'NDT', 'NST_', 'DIG', 'LNGQT', 'ABQRS', 'PVC', 'STD_', 'VCLVH', 'QWAVE', 'LOWT',
    'NT_', 'PAC', 'LPR', 'INVT', 'LVOLT', 'HVOLT', 'TAB_', 'STE_', 'PRC(S)',
)
PTBXL_RHYTHM_CODES: Tuple[str, ...] = (
    'SR', 'AFIB', 'STACH', 'SARRH', 'SBRAD', 'PACE', 'SVARR', 'BIGU', 'AFLT', 'SVTAC',
    'PSVT', 'TRIGU',
)

# diagnostic superclass -> subclass -> codes (reference config.json
# ``diagnostic-class2sub-class2code``; used by the AUROC report plots)
PTBXL_DIAGNOSTIC_TAXONOMY: Dict[str, Dict[str, Tuple[str, ...]]] = {
    'CD': {
        'LAFB/LPFB': ('LAFB', 'LPFB'),
        'IRBBB': ('IRBBB',),
        'ILBBB': ('ILBBB',),
        'CLBBB': ('CLBBB',),
        'CRBBB': ('CRBBB',),
        '_AVB': ('1AVB', '2AVB', '3AVB'),
        'IVCD': ('IVCD',),
        'WPW': ('WPW',),
    },
    'HYP': {
        'LVH': ('LVH',),
        'RVH': ('RVH',),
        'LAO/LAE': ('LAO/LAE',),
        'RAO/RAE': ('RAO/RAE',),
        'SEHYP': ('SEHYP',),
    },
    'MI': {
        'AMI': ('AMI', 'ALMI', 'ASMI'),
        'IMI': ('IMI', 'ILMI', 'IPLMI', 'IPMI', 'INJIN', 'INJIL'),
        'LMI': ('LMI', 'INJLA', 'ISCLA'),
        'PMI': ('PMI',),
    },
    'NORM': {
        'NORM': ('NORM',),
    },
    'STTC': {
        'ISCA': ('ISCAL', 'ISCAS', 'ISCAN', 'INJAS', 'INJAL'),
        'ISCI': ('ISCIN', 'ISCIL'),
        'ISC_': ('ISC_',),
        'STTC': ('NDT', 'DIG', 'LNGQT', 'EL', 'ANEUR'),
        'NST_': ('NST_',),
    },
}

# Subclass descriptions for reporting (reference config.json
# ``diagnostic-sub-class2description``)
PTBXL_SUBCLASS_DESCRIPTION: Dict[str, str] = {
    'LAFB/LPFB': 'left anterior/posterior fascicular block',
    'IRBBB': 'incomplete right bundle branch block',
    'ILBBB': 'incomplete left bundle branch block',
    'CLBBB': 'complete left bundle branch block',
    'CRBBB': 'complete right bundle branch block',
    '_AVB': 'AV block',
    'IVCD': 'non-specific intraventricular conduction disturbance (block)',
    'WPW': 'Wolf-Parkinson-White syndrome',
    'LVH': 'left ventricular hypertrophy',
    'RVH': 'right ventricular hypertrophy',
    'LAO/LAE': 'left atrial overload/enlargement',
    'RAO/RAE': 'right atrial overload/enlargement',
    'SEHYP': 'septal hypertrophy',
    'AMI': 'anterior myocardial infarction',
    'IMI': 'inferior myocardial infarction',
    'LMI': 'lateral myocardial infarction',
    'PMI': 'posterior myocardial infarction',
    'NORM': 'normal ECG',
    'ISCA': 'ischemic in anterior leads',
    'ISCI': 'ischemic in inferior leads',
    'ISC_': 'non-specific ischemic',
    'STTC': 'ST-T changes',
    'NST_': 'non-specific ST changes',
}

TARGET_FQS = 250  # common grid every corpus is resampled to (reference data_export.py:241)
# Standard 12-lead order used throughout (reference util/ecg.py:69)
LEAD_NAMES: Tuple[str, ...] = (
    'I', 'II', 'III', 'avR', 'avL', 'avF', 'V1', 'V2', 'V3', 'V4', 'V5', 'V6'
)
N_LEADS = 12


@dataclasses.dataclass(frozen=True)
class DatasetMeta:
    """Metadata for one public 12-lead corpus (reference config.json ``datasets.*``)."""
    key: str                       # registry key, e.g. 'PTB-XL'
    name: str                      # human-readable name
    dir_name: str                  # directory name under the datasets root
    rec_fmt: Optional[str] = None  # glob pattern for record files
    rec_ext: Optional[str] = None  # record file extension
    fqs: Optional[int] = None      # native sampling frequency (Hz)
    n_rec: Optional[int] = None    # number of records
    n_pat: Optional[object] = None  # number of patients ('?' when unknown upstream)
    reader: str = 'wfdb'           # one of {'wfdb', 'csv', 'hdf5_bulk'} (util/ecg.py:202-217)


DATASETS: Dict[str, DatasetMeta] = {m.key: m for m in [
    DatasetMeta(
        key='BIH-MVED', name='MIT-BIH Malignant Ventricular Ectopy Database',
        dir_name='MIT-BIH-MVED'),
    DatasetMeta(
        key='INCART', name="St Petersburg INCART 12-lead Arrhythmia Database",
        dir_name='St-Petersburg-INCART', rec_fmt='*.dat', rec_ext='.dat',
        fqs=257, n_rec=75, n_pat=32),
    DatasetMeta(
        key='PTB-XL', name='PTB-XL, a large publicly available electrocardiography dataset',
        dir_name='PTB-XL', rec_fmt='records500/**/*.dat', rec_ext='.dat',
        fqs=500, n_rec=21837, n_pat=18885),
    DatasetMeta(
        key='PTB-Diagnostic', name='PTB Diagnostic ECG Database',
        dir_name='PTB-Diagnostic', rec_fmt='*/*.dat', rec_ext='.dat',
        fqs=1000, n_rec=549, n_pat=290),
    DatasetMeta(
        key='CSPC', name='China Physiological Signal Challenge 2018',
        dir_name='CSPC-2018', rec_fmt='*.mat', rec_ext='.mat', fqs=500),
    DatasetMeta(
        key='CSPC-CinC', name='China Physiological Signal Challenge 2018 - from CinC',
        dir_name='CSPC-2018-CinC', rec_fmt='*.mat', rec_ext='.mat',
        fqs=500, n_rec=6877, n_pat=6877),
    DatasetMeta(
        key='CSPC-Extra-CinC',
        name='China Physiological Signal Challenge 2018, unused/extra - from CinC',
        dir_name='CSPC-2018-Extra-CinC', rec_fmt='*.mat', rec_ext='.mat',
        fqs=500, n_rec=3453, n_pat='?'),
    DatasetMeta(
        key='G12EC', name='Georgia 12-lead ECG Challenge (G12EC) Database',
        dir_name='Georgia-12-Lead', rec_fmt='*.mat', rec_ext='.mat',
        fqs=500, n_rec=10344, n_pat='?'),
    DatasetMeta(
        key='CHAP-SHAO', name='Chapman University, Shaoxing People''s Hospital 12-lead ECG Database',
        dir_name='Chapman-Shaoxing', rec_fmt='ECGData/*.csv', rec_ext='.csv',
        fqs=500, n_rec=10646, n_pat=10646, reader='csv'),
    DatasetMeta(
        key='CODE-TEST', name='CODE-test: An annotated 12-lead ECG dataset',
        dir_name='CODE-test', rec_fmt='ecg_tracings.hdf5', rec_ext='.hdf5',
        fqs=400, n_rec=827, n_pat=827, reader='hdf5_bulk'),
]}

# Corpora exported to the unified 250 Hz grid (reference config.py:83-86)
EXPORT_DATASETS: Tuple[str, ...] = (
    'INCART', 'PTB-XL', 'PTB-Diagnostic', 'CSPC-CinC', 'CSPC-Extra-CinC',
    'G12EC', 'CHAP-SHAO', 'CODE-TEST',
)
WFDB_DATASETS: Tuple[str, ...] = (
    'INCART', 'PTB-XL', 'PTB-Diagnostic', 'CSPC-CinC', 'CSPC-Extra-CinC', 'G12EC',
)

RANDOM_SEED = 77  # reference config.json 'random-seed'


# Zheng et al. denoising constants (reference config.json ``pre_processing.zheng``)
@dataclasses.dataclass(frozen=True)
class LowPassSpec:
    passband: float = 50.0              # Hz
    stopband: float = 60.0              # Hz
    passband_ripple: float = 1.0        # dB
    stopband_attenuation: float = 2.5   # dB


@dataclasses.dataclass(frozen=True)
class NlmSpec:
    smooth_factor: float = 1.5  # Gaussian scale factor (config.json nlm.smooth_factor)
    window_size: int = 10       # patch half-width (config.json nlm.window_size)


LOW_PASS = LowPassSpec()
NLM = NlmSpec()

PTBXL_CODE2DESCRIPTION: Dict[str, str] = {
    'NDT': 'non-diagnostic T abnormalities',
    'NST_': 'non-specific ST changes',
    'DIG': 'digitalis-effect',
    'LNGQT': 'long QT-interval',
    'NORM': 'normal ECG',
    'IMI': 'inferior myocardial infarction',
    'ASMI': 'anteroseptal myocardial infarction',
    'LVH': 'left ventricular hypertrophy',
    'LAFB': 'left anterior fascicular block',
    'ISC_': 'non-specific ischemic',
    'IRBBB': 'incomplete right bundle branch block',
    '1AVB': 'first degree AV block',
    'IVCD': 'non-specific intraventricular conduction disturbance (block)',
    'ISCAL': 'ischemic in anterolateral leads',
    'CRBBB': 'complete right bundle branch block',
    'CLBBB': 'complete left bundle branch block',
    'ILMI': 'inferolateral myocardial infarction',
    'LAO/LAE': 'left atrial overload/enlargement',
    'AMI': 'anterior myocardial infarction',
    'ALMI': 'anterolateral myocardial infarction',
    'ISCIN': 'ischemic in inferior leads',
    'INJAS': 'subendocardial injury in anteroseptal leads',
    'LMI': 'lateral myocardial infarction',
    'ISCIL': 'ischemic in inferolateral leads',
    'LPFB': 'left posterior fascicular block',
    'ISCAS': 'ischemic in anteroseptal leads',
    'INJAL': 'subendocardial injury in anterolateral leads',
    'ISCLA': 'ischemic in lateral leads',
    'RVH': 'right ventricular hypertrophy',
    'ANEUR': 'ST-T changes compatible with ventricular aneurysm',
    'RAO/RAE': 'right atrial overload/enlargement',
    'EL': 'electrolytic disturbance or drug (former EDIS)',
    'WPW': 'Wolff-Parkinson-White syndrome',
    'ILBBB': 'incomplete left bundle branch block',
    'IPLMI': 'inferoposterolateral myocardial infarction',
    'ISCAN': 'ischemic in anterior leads',
    'IPMI': 'inferoposterior myocardial infarction',
    'SEHYP': 'septal hypertrophy',
    'INJIN': 'subendocardial injury in inferior leads',
    'INJLA': 'subendocardial injury in lateral leads',
    'PMI': 'posterior myocardial infarction',
    '3AVB': 'third degree AV block',
    'INJIL': 'subendocardial injury in inferolateral leads',
    '2AVB': 'second degree AV block',
    'ABQRS': 'abnormal QRS',
    'PVC': 'ventricular premature complex',
    'STD_': 'non-specific ST depression',
    'VCLVH': 'voltage criteria (QRS) for left ventricular hypertrophy',
    'QWAVE': 'Q waves present',
    'LOWT': 'low amplitude T-waves',
    'NT_': 'non-specific T-wave changes',
    'PAC': 'atrial premature complex',
    'LPR': 'prolonged PR interval',
    'INVT': 'inverted T-waves',
    'LVOLT': 'low QRS voltages in the frontal and horizontal leads',
    'HVOLT': 'high QRS voltage',
    'TAB_': 'T-wave abnormality',
    'STE_': 'non-specific ST elevation',
    'PRC(S)': 'premature complex(es)',
    'SR': 'sinus rhythm',
    'AFIB': 'atrial fibrillation',
    'STACH': 'sinus tachycardia',
    'SARRH': 'sinus arrhythmia',
    'SBRAD': 'sinus bradycardia',
    'PACE': 'normal functioning artificial pacemaker',
    'SVARR': 'supraventricular arrhythmia',
    'BIGU': 'bigeminal pattern (unknown origin, SV or Ventricular)',
    'AFLT': 'atrial flutter',
    'SVTAC': 'supraventricular tachycardia',
    'PSVT': 'paroxysmal supraventricular tachycardia',
    'TRIGU': 'trigeminal pattern (unknown origin, SV or Ventricular)',
}
assert set(PTBXL_CODE2DESCRIPTION) == set(PTBXL_ID2CODE)


def ptbxl_code_aspects(code: str) -> List[str]:
    """Aspects ('diagnostic' / 'form' / 'rhythm') a code belongs to."""
    aspects = []
    for cls in PTBXL_DIAGNOSTIC_TAXONOMY.values():
        for codes in cls.values():
            if code in codes:
                aspects.append('diagnostic')
                break
        if aspects:
            break
    if code in PTBXL_FORM_CODES:
        aspects.append('form')
    if code in PTBXL_RHYTHM_CODES:
        aspects.append('rhythm')
    return aspects


def ptbxl_diagnostic_class(code: str) -> Optional[Tuple[str, str]]:
    """(superclass, subclass) of a diagnostic code, or None."""
    for sup, sub2codes in PTBXL_DIAGNOSTIC_TAXONOMY.items():
        for sub, codes in sub2codes.items():
            if code in codes:
                return sup, sub
    return None


# PTB-XL train-split (strat_fold 1-8) per-lead statistics, for the 'original'
# (resampled only) and 'denoised' (full Zheng chain) exports
PTBXL_TRAIN_STATS: Dict[str, Dict[str, Tuple[float, ...]]] = {
    'original': {
        'mean': (-0.0019577480852603912, -0.0015135634457692504, 0.0004490820283535868,
                 0.0017203569877892733, -0.0011522460263222456, -0.0005099240224808455,
                 0.00017943125567398965, -0.000944361265283078, -0.0015521063469350338,
                 -0.0013858146267011762, -0.0013661786215379834, -0.00129299599211663),
        'std': (0.18731684982776642, 0.1654723584651947, 0.1817007064819336,
                0.14463680982589722, 0.1585516482591629, 0.14973415434360504,
                0.23492559790611267, 0.337680846452713, 0.33523011207580566,
                0.2991229295730591, 0.2941807210445404, 0.24228161573410034),
    },
    'denoised': {
        'mean': (0.031693775206804276, 0.026335246860980988, -0.006399692501872778,
                 -0.029242346063256264, 0.018595218658447266, 0.009771836921572685,
                 -0.029959620907902718, -0.003512350842356682, 0.017835726961493492,
                 0.037346456199884415, 0.045144204050302505, 0.040031980723142624),
        'std': (0.16359058022499084, 0.14729931950569153, 0.1592119336128235,
                0.130726158618927, 0.14059293270111084, 0.1309490203857422,
                0.20307090878486633, 0.31549230217933655, 0.31034034490585327,
                0.2784479260444641, 0.24767889082431793, 0.19650913774967194),
    },
}


def config(dotted_key: str):
    """Dot-path accessor over the registry, mirroring the reference's
    ``config('a.b.c')`` API (util/util.py:87-96) for drop-in familiarity.

    Supported roots: ``datasets.<KEY>.<field>``, ``datasets.PTB-XL.code.*``,
    ``datasets.PTB-XL.train-stats.*``, ``pre_processing.zheng.*``,
    ``datasets-export.*``, ``random-seed``.
    """
    parts = dotted_key.split('.')
    root = {
        'datasets': _config_datasets,
        'datasets-export': lambda: {'total': list(EXPORT_DATASETS),
                                    'support_wfdb': list(WFDB_DATASETS)},
        'pre_processing': lambda: {'zheng': {
            'low_pass': dataclasses.asdict(LOW_PASS),
            'nlm': {'smooth_factor': NLM.smooth_factor,
                    'window_size': NLM.window_size}}},
        'random-seed': lambda: RANDOM_SEED,
    }
    if parts[0] not in root:
        raise KeyError(dotted_key)
    node = root[parts[0]]()
    for p in parts[1:]:
        node = node[p]
    return node


def _config_datasets():
    out = {}
    for key, meta in DATASETS.items():
        d = {k: v for k, v in dataclasses.asdict(meta).items() if v is not None}
        d['nm'] = d.pop('name')
        d['dir_nm'] = d.pop('dir_name')
        out[key] = d
    out['PTB-XL']['code'] = {
        'id2code': list(PTBXL_ID2CODE),
        'code2id': dict(PTBXL_CODE2ID),
        'form-codes': list(PTBXL_FORM_CODES),
        'rhythm-codes': list(PTBXL_RHYTHM_CODES),
        'diagnostic-class2sub-class2code': {
            sup: {sub: list(cs) for sub, cs in subs.items()}
            for sup, subs in PTBXL_DIAGNOSTIC_TAXONOMY.items()},
        'diagnostic-sub-class2description': dict(PTBXL_SUBCLASS_DESCRIPTION),
        'code2description': dict(PTBXL_CODE2DESCRIPTION),
    }
    out['PTB-XL']['train-stats'] = {
        t: {k: list(v) for k, v in d.items()}
        for t, d in PTBXL_TRAIN_STATS.items()}
    return out
