"""AccessControl seam + warning collector.

Reference: the ``AccessControl`` SPI (``io.trino.security.AccessControl``,
``spi/security/SystemAccessControl``) gates every table/column read and
write; deployments plug in file-based or LDAP-backed rules.  Here the seam
is the same two calls the engine needs (select/write) with an allow-all
default and a rule-based implementation for tests — enough that nothing
in the engine touches a table without passing through the check.

``WarningCollector`` mirrors ``spi/WarningCollector``: non-fatal planning
and execution notes accumulate per query and surface through the DB-API
cursor and the HTTP protocol's ``warnings`` field.

A copy of ``presto_tpu/utils/security.py`` (it imports no jax).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple


class AccessDeniedError(Exception):
    pass


class AccessControl:
    """Allow-all default (the reference's ``AllowAllAccessControl``)."""

    def check_can_select(self, table: str,
                         columns: Sequence[str]) -> None:
        return

    def check_can_write(self, table: str) -> None:
        return


@dataclass
class RuleBasedAccessControl(AccessControl):
    """Deny-by-rule access control (``FileBasedAccessControl`` shape):
    explicit denied tables/columns and a read-only flag."""

    denied_tables: Set[str] = field(default_factory=set)
    denied_columns: Dict[str, Set[str]] = field(default_factory=dict)
    read_only: bool = False

    def check_can_select(self, table: str,
                         columns: Sequence[str]) -> None:
        if table in self.denied_tables:
            raise AccessDeniedError(f"Access Denied: table {table}")
        bad = self.denied_columns.get(table, set()) & set(columns)
        if bad:
            raise AccessDeniedError(
                f"Access Denied: columns {sorted(bad)} of {table}")

    def check_can_write(self, table: str) -> None:
        if self.read_only or table in self.denied_tables:
            raise AccessDeniedError(f"Access Denied: write to {table}")


@dataclass
class Warning_:
    code: str
    message: str


class WarningCollector:
    def __init__(self):
        self.warnings: List[Warning_] = []

    def add(self, code: str, message: str) -> None:
        # dedupe repeated identical warnings (retry loops re-plan)
        for w in self.warnings:
            if w.code == code and w.message == message:
                return
        self.warnings.append(Warning_(code, message))

    def as_dicts(self) -> List[dict]:
        return [{"warningCode": w.code, "message": w.message}
                for w in self.warnings]
