"""SQL tokenizer for the TPC dialect subset.

Port copy of ``nds_tpu/sql/lexer.py``: it imports nothing of ``nds_tpu``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass


@dataclass
class Token:
    kind: str    # ident|number|string|op|punct|eof
    value: str
    pos: int


_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|--[^\n]*\n?|/\*.*?\*/)
  | (?P<number>\d+\.\d+|\.\d+|\d+)
  | (?P<string>'(?:[^']|'')*')
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*|`[^`]*`|"[^"]*")
  | (?P<op><=|>=|<>|!=|\|\||[=<>+\-*/%])
  | (?P<punct>[(),.;])
    """,
    re.VERBOSE | re.DOTALL,
)


class LexError(ValueError):
    pass


def tokenize(sql: str) -> list[Token]:
    tokens: list[Token] = []
    pos = 0
    n = len(sql)
    while pos < n:
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            snippet = sql[pos:pos + 20]
            raise LexError(f"unexpected character at {pos}: {snippet!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        value = m.group()
        if kind == "string":
            value = value[1:-1].replace("''", "'")
        elif kind == "ident":
            if value[0] in "`\"":
                value = value[1:-1]
        tokens.append(Token(kind, value, m.start()))
    tokens.append(Token("eof", "", n))
    return tokens
