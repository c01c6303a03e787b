"""PTB-XL code tables, grid constants and normalization statistics.

A copy of the tables in the JAX package's ``registry.py`` (the port imports
nothing of that package): the 71-code id order, the per-code descriptions,
the 250 Hz 12-lead grid and the train-split per-lead statistics.  ``tests/test_torch_imports.py`` and
``tests/test_torch_serving.py`` hold the copy equal to the original.
"""
from __future__ import annotations

from typing import Dict, Tuple

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
PTBXL_N_CLASS = len(PTBXL_ID2CODE)
assert PTBXL_N_CLASS == 71

TARGET_FQS = 250  # common grid every corpus is resampled to (reference data_export.py:241)
N_LEADS = 12

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
