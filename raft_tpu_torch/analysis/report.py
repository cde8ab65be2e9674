"""Shared findings output for the analysis CLI engines (the
reference's ``raft_tpu/analysis/report.py``).

Every engine (lint, concurrency, schemas, protocol) funnels its
findings through :func:`emit` so ``--json`` means the same thing
everywhere: a single JSON document on stdout with one record per
finding (``file``/``line``/``col``/``rule``/``message``) plus engine
metadata — stable keys for CI tooling to consume without scraping the
human text format.  Text mode is byte-identical to the historical
per-engine output.
"""

from __future__ import annotations

import json
import sys


def to_record(finding):
    """Normalize one finding into the machine-readable record shape.

    Accepts :class:`raft_tpu_torch.analysis.lint.Finding` (and anything
    duck-typed to it), plain dicts, or bare strings (the schemas
    engine's violation lines, which carry no file position).
    """
    if isinstance(finding, str):
        return {"file": None, "line": None, "col": None,
                "rule": "schema-contract", "message": finding}
    if isinstance(finding, dict):
        rec = {"file": None, "line": None, "col": None, "rule": None,
               "message": None}
        rec.update(finding)
        return rec
    return {"file": finding.path, "line": finding.line,
            "col": finding.col, "rule": finding.rule,
            "message": finding.message}


def emit(engine, findings, as_json, clean_note=None, extra=None,
         stream=None):
    """Print findings in the selected format; return the exit code.

    Text mode preserves each engine's historical layout: one formatted
    finding per line on stdout, a count hint on stderr when dirty, the
    ``clean_note`` on stdout when clean.  JSON mode prints one document
    with ``engine``, ``findings`` and any ``extra`` metadata.
    """
    stream = stream or sys.stdout
    if as_json:
        doc = {"engine": engine, "clean": not findings,
               "findings": [to_record(f) for f in findings]}
        if extra:
            doc.update(extra)
        json.dump(doc, stream, indent=1, sort_keys=True)
        stream.write("\n")
        return 1 if findings else 0
    for f in findings:
        print(f if isinstance(f, str) else f.format(), file=stream)
    if findings:
        return 1
    if clean_note:
        print(clean_note, file=stream)
    return 0
