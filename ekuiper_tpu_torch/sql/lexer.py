"""SQL lexer — analogue of eKuiper's internal/xsql/lexical.go (Scanner.Scan).

Produces a token stream for the parser. Keywords are case-insensitive;
identifiers keep their case (optionally backtick-quoted to escape keywords).
String literals: double- or single-quoted. Comments: `--` to EOL and /* */.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ..utils.infra import ParseError

# token kinds
EOF = "EOF"
IDENT = "IDENT"
INTEGER = "INTEGER"
NUMBER = "NUMBER"
STRING = "STRING"
OP = "OP"  # operators & punctuation, tok.text holds which
KEYWORD = "KEYWORD"

KEYWORDS = {
    "SELECT", "FROM", "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "CROSS", "ON",
    "WHERE", "LIMIT", "GROUP", "ORDER", "HAVING", "BY", "ASC", "DESC",
    "FILTER", "CASE", "WHEN", "THEN", "ELSE", "END", "OVER", "PARTITION",
    "INVISIBLE", "AND", "OR", "NOT", "IN", "BETWEEN", "LIKE", "AS", "TRUE",
    "FALSE", "REPLACE", "EXCEPT",
    # DDL words are plain idents in the reference scanner but keywords here
    # for convenience; the parser treats them contextually
    "CREATE", "DROP", "EXPLAIN", "DESCRIBE", "DESC", "SHOW", "STREAM",
    "TABLE", "STREAMS", "TABLES", "WITH",
}

# time-unit literals inside window calls
TIME_UNITS = {"DD", "HH", "MI", "SS", "MS"}

MULTI_OPS = ["<=", ">=", "!=", "<>", "->"]
SINGLE_OPS = "+-*/%&|^=<>[](),.#:;"


@dataclass
class Token:
    kind: str
    text: str
    pos: int

    def __repr__(self) -> str:
        return f"{self.kind}({self.text!r})"


def tokenize(sql: str) -> List[Token]:
    tokens: List[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if c == "-" and i + 1 < n and sql[i + 1] == "-":
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "/" and i + 1 < n and sql[i + 1] == "*":
            j = sql.find("*/", i + 2)
            if j < 0:
                raise ParseError(f"unterminated comment at {i}")
            i = j + 2
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = False
            seen_exp = False
            while j < n:
                ch = sql[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_exp:
                    # "1." followed by non-digit is int + DOT (json path)
                    if j + 1 < n and sql[j + 1].isdigit():
                        seen_dot = True
                        j += 1
                    else:
                        break
                elif ch in "eE" and not seen_exp and j + 1 < n and (
                    sql[j + 1].isdigit()
                    or (sql[j + 1] in "+-" and j + 2 < n and sql[j + 2].isdigit())
                ):
                    seen_exp = True
                    j += 2 if sql[j + 1] in "+-" else 1
                else:
                    break
            text = sql[i:j]
            kind = NUMBER if (seen_dot or seen_exp) else INTEGER
            tokens.append(Token(kind, text, i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            text = sql[i:j]
            upper = text.upper()
            if upper in KEYWORDS:
                tokens.append(Token(KEYWORD, upper, i))
            else:
                tokens.append(Token(IDENT, text, i))
            i = j
            continue
        if c == "`":
            j = sql.find("`", i + 1)
            if j < 0:
                raise ParseError(f"unterminated quoted identifier at {i}")
            tokens.append(Token(IDENT, sql[i + 1:j], i))
            i = j + 1
            continue
        if c in ("'", '"'):
            quote = c
            j = i + 1
            buf = []
            while j < n:
                if sql[j] == "\\" and j + 1 < n:
                    esc = sql[j + 1]
                    buf.append({"n": "\n", "t": "\t", "r": "\r"}.get(esc, esc))
                    j += 2
                elif sql[j] == quote:
                    break
                else:
                    buf.append(sql[j])
                    j += 1
            if j >= n:
                raise ParseError(f"unterminated string at {i}")
            tokens.append(Token(STRING, "".join(buf), i))
            i = j + 1
            continue
        matched = False
        for op in MULTI_OPS:
            if sql.startswith(op, i):
                tokens.append(Token(OP, "!=" if op == "<>" else op, i))
                i += len(op)
                matched = True
                break
        if matched:
            continue
        if c in SINGLE_OPS:
            tokens.append(Token(OP, c, i))
            i += 1
            continue
        raise ParseError(f"illegal character {c!r} at position {i}")
    tokens.append(Token(EOF, "", n))
    return tokens


class TokenStream:
    def __init__(self, sql: str) -> None:
        self.sql = sql
        self.tokens = tokenize(sql)
        self.i = 0

    def peek(self, ahead: int = 0) -> Token:
        j = min(self.i + ahead, len(self.tokens) - 1)
        return self.tokens[j]

    def next(self) -> Token:
        tok = self.tokens[self.i]
        if self.i < len(self.tokens) - 1:
            self.i += 1
        return tok

    def accept(self, kind: str, text: Optional[str] = None) -> Optional[Token]:
        tok = self.peek()
        if tok.kind == kind and (text is None or tok.text == text):
            return self.next()
        return None

    def expect(self, kind: str, text: Optional[str] = None) -> Token:
        tok = self.accept(kind, text)
        if tok is None:
            got = self.peek()
            want = text or kind
            raise ParseError(
                f"expected {want} but found {got.text or got.kind!r} at position {got.pos}"
            )
        return tok

    def at_keyword(self, *words: str) -> bool:
        tok = self.peek()
        return tok.kind == KEYWORD and tok.text in words
