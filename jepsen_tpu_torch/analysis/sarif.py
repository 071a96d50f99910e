"""SARIF 2.1.0 export for planelint findings.

CI systems (GitHub code scanning, most review bots) annotate diffs
from SARIF, so ``cli lint --sarif out.sarif`` turns every JT rule
into a line-anchored review comment with zero extra glue. The emitter
writes the minimal conforming subset of SARIF 2.1.0 — one run, the
rule catalog under ``tool.driver.rules``, one ``result`` per finding
— and ``validate_sarif`` checks documents against ``MINIMAL_SCHEMA``,
a stdlib-only JSON-Schema subset validator (analysis/ stays
importable with no third-party deps; the tier-1 test additionally
cross-checks with ``jsonschema`` when it is installed).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from jepsen_tpu_torch.analysis.findings import Finding

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA_URI = (
    "https://docs.oasis-open.org/sarif/sarif/v2.1.0/errata01/os/"
    "schemas/sarif-schema-2.1.0.json"
)

#: the subset of the SARIF 2.1.0 schema planelint emits against —
#: enough to catch every structural mistake that would make a CI
#: ingester reject or silently drop the file.
MINIMAL_SCHEMA: dict = {
    "type": "object",
    "required": ["version", "runs"],
    "properties": {
        "version": {"type": "string", "enum": [SARIF_VERSION]},
        "$schema": {"type": "string"},
        "runs": {
            "type": "array",
            "items": {
                "type": "object",
                "required": ["tool", "results"],
                "properties": {
                    "tool": {
                        "type": "object",
                        "required": ["driver"],
                        "properties": {
                            "driver": {
                                "type": "object",
                                "required": ["name"],
                                "properties": {
                                    "name": {"type": "string"},
                                    "informationUri": {
                                        "type": "string"
                                    },
                                    "rules": {
                                        "type": "array",
                                        "items": {
                                            "type": "object",
                                            "required": ["id"],
                                            "properties": {
                                                "id": {
                                                    "type": "string"
                                                },
                                                "shortDescription": {
                                                    "type": "object",
                                                    "required": [
                                                        "text"
                                                    ],
                                                    "properties": {
                                                        "text": {
                                                            "type": (
                                                                "string"
                                                            )
                                                        }
                                                    },
                                                },
                                                "fullDescription": {
                                                    "type": "object",
                                                    "required": [
                                                        "text"
                                                    ],
                                                    "properties": {
                                                        "text": {
                                                            "type": (
                                                                "string"
                                                            )
                                                        }
                                                    },
                                                },
                                            },
                                        },
                                    },
                                },
                            }
                        },
                    },
                    "results": {
                        "type": "array",
                        "items": {
                            "type": "object",
                            "required": ["ruleId", "message"],
                            "properties": {
                                "ruleId": {"type": "string"},
                                "level": {
                                    "type": "string",
                                    "enum": [
                                        "none", "note", "warning",
                                        "error",
                                    ],
                                },
                                "message": {
                                    "type": "object",
                                    "required": ["text"],
                                    "properties": {
                                        "text": {"type": "string"}
                                    },
                                },
                                "locations": {
                                    "type": "array",
                                    "items": {
                                        "type": "object",
                                        "properties": {
                                            "physicalLocation": {
                                                "type": "object",
                                                "properties": {
                                                    "artifactLocation": {
                                                        "type": (
                                                            "object"
                                                        ),
                                                        "required": [
                                                            "uri"
                                                        ],
                                                        "properties": {
                                                            "uri": {
                                                                "type": (
                                                                    "string"
                                                                )
                                                            }
                                                        },
                                                    },
                                                    "region": {
                                                        "type": (
                                                            "object"
                                                        ),
                                                        "properties": {
                                                            "startLine": {
                                                                "type": (
                                                                    "integer"
                                                                )
                                                            },
                                                            "startColumn": {
                                                                "type": (
                                                                    "integer"
                                                                )
                                                            },
                                                        },
                                                    },
                                                },
                                            }
                                        },
                                    },
                                },
                            },
                        },
                    },
                },
            },
        },
    },
}


def to_sarif(
    findings: Sequence[Finding],
    rules: Dict[str, Tuple[str, str]],
    uri_prefix: str = "jepsen_tpu_torch/",
) -> dict:
    """One SARIF 2.1.0 run. ``uri_prefix`` maps the package-relative
    paths findings carry onto repo-relative URIs so CI annotates the
    right files."""
    rule_objs = [
        {
            "id": rid,
            "shortDescription": {"text": title},
            "fullDescription": {"text": invariant},
        }
        for rid, (title, invariant) in sorted(rules.items())
    ]
    results = []
    for f in findings:
        results.append(
            {
                "ruleId": f.rule,
                "level": "error" if f.severity == "error" else "warning",
                "message": {
                    "text": f"{f.message}  (in {f.symbol})",
                },
                "locations": [
                    {
                        "physicalLocation": {
                            "artifactLocation": {
                                "uri": f"{uri_prefix}{f.file}",
                            },
                            "region": {
                                "startLine": max(f.line, 1),
                                "startColumn": max(f.col + 1, 1),
                            },
                        }
                    }
                ],
            }
        )
    return {
        "$schema": SARIF_SCHEMA_URI,
        "version": SARIF_VERSION,
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "planelint",
                        "informationUri": (
                            "https://github.com/jepsen-tpu"
                        ),
                        "rules": rule_objs,
                    }
                },
                "results": results,
            }
        ],
    }


def validate_sarif(doc: object, schema: dict = MINIMAL_SCHEMA,
                   path: str = "$") -> List[str]:
    """Errors (empty = valid) from checking ``doc`` against the
    JSON-Schema subset used by MINIMAL_SCHEMA: type / required /
    properties / items / enum."""
    errors: List[str] = []
    typ = schema.get("type")
    if typ is not None:
        py = {
            "object": dict,
            "array": list,
            "string": str,
            "integer": int,
            "number": (int, float),
            "boolean": bool,
        }[typ]
        if isinstance(doc, bool) and typ in ("integer", "number"):
            errors.append(f"{path}: expected {typ}, got bool")
            return errors
        if not isinstance(doc, py):
            errors.append(
                f"{path}: expected {typ}, got {type(doc).__name__}"
            )
            return errors
    enum = schema.get("enum")
    if enum is not None and doc not in enum:
        errors.append(f"{path}: {doc!r} not in {enum!r}")
    if isinstance(doc, dict):
        for req in schema.get("required", ()):
            if req not in doc:
                errors.append(f"{path}: missing required key {req!r}")
        props = schema.get("properties", {})
        for key, sub in props.items():
            if key in doc:
                errors.extend(
                    validate_sarif(doc[key], sub, f"{path}.{key}")
                )
    if isinstance(doc, list):
        item_schema = schema.get("items")
        if item_schema is not None:
            for i, item in enumerate(doc):
                errors.extend(
                    validate_sarif(item, item_schema, f"{path}[{i}]")
                )
    return errors
