"""Registry generators: rebuild the PTB-XL taxonomy from source metadata (the
JAX package's ``registry_gen.py``).

The reference generates its taxonomy by parsing ``scp_statements.csv``
(util/config.py:105-271 ``extract_ptb_codes``); the shipped :mod:`.registry`
freezes that output as data.  This module regenerates it from the same CSV so
the registry can be audited or refreshed when PhysioNet updates PTB-XL.

The JAX package reads the CSV with pandas; here the stdlib ``csv`` module
reads it with pandas' meaning of a cell: a missing value (blank, or one of
pandas' default NA strings) is NaN, so a flag compares unequal to 1 and a text
field becomes ``'nan'`` -- a diagnostic code with a blank class is filed under
``'nan'``, as the JAX package files it, not under ``'UNK'`` (which only a
missing column gives).

Usage::

    python -m ecg_representation_learning_tpu_torch.registry_gen \\
        --scp-statements ~/datasets/PTB-XL/scp_statements.csv [--verify]
"""
from __future__ import annotations

import csv
from typing import Dict, List

# pandas' default ``na_values`` (pandas.read_csv)
_NA = frozenset({'', '#N/A', '#N/A N/A', '#NA', '-1.#IND', '-1.#QNAN', '-NaN', '-nan',
                 '1.#IND', '1.#QNAN', '<NA>', 'N/A', 'NA', 'NULL', 'NaN', 'None', 'n/a',
                 'nan', 'null'})


def _flag(row: Dict[str, str], key: str) -> bool:
    """pandas' ``row.get(key, 0) == 1``: NaN and a missing column are not 1."""
    v = row.get(key)
    if v is None or v in _NA:
        return False
    try:
        return float(v) == 1
    except ValueError:
        return False


def _text(row: Dict[str, str], key: str) -> str:
    """pandas' ``str(row.get(key, ''))``: NaN reads 'nan', a missing column ''."""
    v = row.get(key)
    if v is None:
        return ''
    return 'nan' if v in _NA else v


def extract_ptb_codes(scp_statements_csv: str) -> Dict[str, object]:
    """Parse scp_statements.csv -> the taxonomy structures of the registry.

    Codes are kept in CSV row order restricted to rows flagged diagnostic,
    form, or rhythm (the reference's id assignment); returns id2code,
    aspect memberships, the diagnostic class->subclass->code map, and
    per-code descriptions.
    """
    id2code: List[str] = []
    form_codes: List[str] = []
    rhythm_codes: List[str] = []
    diag: Dict[str, Dict[str, List[str]]] = {}
    code2description: Dict[str, str] = {}
    with open(scp_statements_csv, newline='') as f:
        reader = csv.reader(f)
        header = next(reader)
        for cells in reader:
            code, row = cells[0], dict(zip(header[1:], cells[1:]))
            is_diag = _flag(row, 'diagnostic')
            is_form = _flag(row, 'form')
            is_rhythm = _flag(row, 'rhythm')
            if not (is_diag or is_form or is_rhythm):
                continue
            id2code.append(code)
            code2description[code] = _text(row, 'description')
            if is_form:
                form_codes.append(code)
            if is_rhythm:
                rhythm_codes.append(code)
            if is_diag:
                sup = _text(row, 'diagnostic_class') or 'UNK'
                sub = _text(row, 'diagnostic_subclass') or code
                diag.setdefault(sup, {}).setdefault(sub, []).append(code)
    return {
        'id2code': id2code,
        'code2id': {c: i for i, c in enumerate(id2code)},
        'form_codes': form_codes,
        'rhythm_codes': rhythm_codes,
        'diagnostic_taxonomy': diag,
        'code2description': code2description,
    }


def verify_against_registry(extracted: Dict[str, object]) -> List[str]:
    """Diff the extracted taxonomy against the frozen registry; returns a list
    of human-readable discrepancies (empty = registry is current)."""
    from . import registry as R
    problems = []
    if list(extracted['id2code']) != list(R.PTBXL_ID2CODE):
        problems.append('id2code order differs from registry.PTBXL_ID2CODE')
    if set(extracted['form_codes']) != set(R.PTBXL_FORM_CODES):
        problems.append('form code set differs')
    if set(extracted['rhythm_codes']) != set(R.PTBXL_RHYTHM_CODES):
        problems.append('rhythm code set differs')
    reg_diag = {sup: {sub: set(cs) for sub, cs in subs.items()}
                for sup, subs in R.PTBXL_DIAGNOSTIC_TAXONOMY.items()}
    ext_diag = {sup: {sub: set(cs) for sub, cs in subs.items()}
                for sup, subs in extracted['diagnostic_taxonomy'].items()}
    if reg_diag != ext_diag:
        problems.append('diagnostic taxonomy differs')
    ext_desc = dict(extracted['code2description'])
    if ext_desc != dict(R.PTBXL_CODE2DESCRIPTION):
        diff = [c for c in ext_desc
                if ext_desc.get(c) != R.PTBXL_CODE2DESCRIPTION.get(c)]
        diff += [c for c in R.PTBXL_CODE2DESCRIPTION if c not in ext_desc]
        problems.append(f'code2description differs for: {sorted(set(diff))}')
    return problems


def main(argv=None):
    import argparse
    import json

    p = argparse.ArgumentParser()
    p.add_argument('--scp-statements', required=True)
    p.add_argument('--verify', action='store_true',
                   help='diff against the frozen registry instead of printing')
    args = p.parse_args(argv)
    ext = extract_ptb_codes(args.scp_statements)
    if args.verify:
        problems = verify_against_registry(ext)
        print(json.dumps({'ok': not problems, 'problems': problems}))
    else:
        print(json.dumps(ext, indent=2))


if __name__ == '__main__':
    main()
