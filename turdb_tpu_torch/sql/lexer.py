"""SQL tokenizer.

Counterpart of reference src/sql/lexer.rs (zero-copy tokenizer with
line/col spans, :5-30) and token.rs (keyword inventory + vector operators
`<->`/`<#>`/`<=>`, :89-160). Python strings are immutable slices, so
"zero-copy" here is slice-based with (line, col) spans for errors.
"""

from __future__ import annotations

import dataclasses
import enum


class SqlError(Exception):
    def __init__(self, msg: str, line: int = 0, col: int = 0):
        super().__init__(f"{msg} at line {line}:{col}" if line else msg)
        self.line = line
        self.col = col


class T(enum.Enum):
    KEYWORD = "kw"
    IDENT = "ident"
    STRING = "str"
    BLOB = "blob"         # x'ABCD' hex literal (value = hex digits)
    NUMBER = "num"
    PARAM = "param"       # ? or $n
    OP = "op"
    LPAREN = "("
    RPAREN = ")"
    COMMA = ","
    SEMI = ";"
    DOT = "."
    LBRACKET = "["
    RBRACKET = "]"
    EOF = "eof"


KEYWORDS = {
    # core DML/DQL
    "SELECT", "FROM", "WHERE", "GROUP", "BY", "HAVING", "ORDER", "LIMIT",
    "OFFSET", "DISTINCT", "ALL", "AS", "INSERT", "INTO", "VALUES", "UPDATE",
    "SET", "DELETE", "RETURNING", "ON", "CONFLICT", "DO", "NOTHING",
    # joins
    "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "OUTER", "CROSS", "USING",
    "NATURAL",
    # set ops / CTE
    "UNION", "INTERSECT", "EXCEPT", "WITH", "RECURSIVE",
    # expressions
    "AND", "OR", "NOT", "NULL", "TRUE", "FALSE", "IS", "IN", "LIKE", "ILIKE",
    "BETWEEN", "CASE", "WHEN", "THEN", "ELSE", "END", "CAST", "EXISTS", "ANY",
    "SOME", "ARRAY", "ASC", "DESC", "NULLS", "FIRST", "LAST", "ESCAPE",
    # DDL
    "CREATE", "TABLE", "INDEX", "SCHEMA", "DROP", "ALTER", "ADD", "COLUMN",
    "RENAME", "TO", "IF", "UNIQUE", "PRIMARY", "KEY", "FOREIGN", "REFERENCES",
    "CHECK", "DEFAULT", "CONSTRAINT", "CASCADE", "RESTRICT", "ACTION",
    "TRUNCATE", "VACUUM", "ANALYZE", "VIEW", "REPLACE", "MATERIALIZED",
    "SHOW", "SESSION", "LOCAL",
    # txn
    "BEGIN", "COMMIT", "ROLLBACK", "SAVEPOINT", "RELEASE", "TRANSACTION",
    "START", "WORK", "FOR",
    # misc
    "EXPLAIN", "PRAGMA", "VERBOSE", "FILTER", "OVER", "PARTITION",
    "INTERVAL", "DATE", "TIME", "TIMESTAMP", "VECTOR", "COLLATE",
}

# multi-char operators, longest first (vector ops per reference
# token.rs:89-160: <-> L2, <#> negative IP, <=> cosine)
_OPS = [
    "<->", "<#>", "<=>", "->>", "<@", "@>", "->", "||", "&&", "::", "<=", ">=",
    "<>", "!=", "=", "<", ">", "+", "-", "*", "/", "%", "|", "@", "#", "~",
]


@dataclasses.dataclass
class Token:
    type: T
    value: str
    line: int
    col: int
    off: int = 0       # byte offset of the token start in the source

    def is_kw(self, *names: str) -> bool:
        return self.type is T.KEYWORD and self.value in names


class Lexer:
    def __init__(self, sql: str):
        self.sql = sql
        self.i = 0
        self.line = 1
        self.col = 1
        self.n = len(sql)

    def error(self, msg):
        raise SqlError(msg, self.line, self.col)

    def _adv(self, k: int = 1):
        for _ in range(k):
            if self.i < self.n and self.sql[self.i] == "\n":
                self.line += 1
                self.col = 1
            else:
                self.col += 1
            self.i += 1

    def _skip_ws(self):
        while self.i < self.n:
            c = self.sql[self.i]
            if c in " \t\r\n":
                self._adv()
            elif c == "-" and self.sql[self.i : self.i + 2] == "--":
                while self.i < self.n and self.sql[self.i] != "\n":
                    self._adv()
            elif c == "/" and self.sql[self.i : self.i + 2] == "/*":
                depth = 1
                self._adv(2)
                while self.i < self.n and depth:
                    if self.sql[self.i : self.i + 2] == "/*":
                        depth += 1
                        self._adv(2)
                    elif self.sql[self.i : self.i + 2] == "*/":
                        depth -= 1
                        self._adv(2)
                    else:
                        self._adv()
                if depth:
                    self.error("unterminated block comment")
            else:
                return

    def next_token(self) -> Token:
        self._skip_ws()
        off = self.i
        t = self._lex_token()
        t.off = off
        return t

    def _lex_token(self) -> Token:
        line, col = self.line, self.col
        if self.i >= self.n:
            return Token(T.EOF, "", line, col)
        c = self.sql[self.i]

        if c.isalpha() or c == "_":
            start = self.i
            while self.i < self.n and (
                self.sql[self.i].isalnum() or self.sql[self.i] == "_"
            ):
                self._adv()
            word = self.sql[start : self.i]
            up = word.upper()
            if up == "X" and self.i < self.n and self.sql[self.i] == "'":
                # hex blob literal x'DEADBEEF' (reference literal.rs)
                self._adv()
                hstart = self.i
                while self.i < self.n and self.sql[self.i] != "'":
                    self._adv()
                if self.i >= self.n:
                    self.error("unterminated blob literal")
                hexs = self.sql[hstart : self.i]
                self._adv()
                if len(hexs) % 2 or any(
                    ch not in "0123456789abcdefABCDEF" for ch in hexs
                ):
                    self.error("invalid hex blob literal")
                return Token(T.BLOB, hexs, line, col)
            if up in KEYWORDS:
                return Token(T.KEYWORD, up, line, col)
            return Token(T.IDENT, word, line, col)

        if c == '"':
            self._adv()
            start = self.i
            out = []
            while True:
                if self.i >= self.n:
                    self.error("unterminated quoted identifier")
                if self.sql[self.i] == '"':
                    if self.sql[self.i + 1 : self.i + 2] == '"':
                        out.append(self.sql[start : self.i] + '"')
                        self._adv(2)
                        start = self.i
                        continue
                    out.append(self.sql[start : self.i])
                    self._adv()
                    break
                self._adv()
            return Token(T.IDENT, "".join(out), line, col)

        if c == "'":
            self._adv()
            start = self.i
            out = []
            while True:
                if self.i >= self.n:
                    self.error("unterminated string literal")
                if self.sql[self.i] == "'":
                    if self.sql[self.i + 1 : self.i + 2] == "'":
                        out.append(self.sql[start : self.i] + "'")
                        self._adv(2)
                        start = self.i
                        continue
                    out.append(self.sql[start : self.i])
                    self._adv()
                    break
                self._adv()
            return Token(T.STRING, "".join(out), line, col)

        if c.isdigit() or (c == "." and self.sql[self.i + 1 : self.i + 2].isdigit()):
            start = self.i
            if self.sql[self.i : self.i + 2].lower() == "0x":
                self._adv(2)
                while self.i < self.n and self.sql[self.i] in "0123456789abcdefABCDEF":
                    self._adv()
                return Token(T.NUMBER, self.sql[start : self.i], line, col)
            seen_dot = seen_e = False
            while self.i < self.n:
                ch = self.sql[self.i]
                if ch.isdigit():
                    self._adv()
                elif ch == "." and not seen_dot and not seen_e:
                    seen_dot = True
                    self._adv()
                elif ch in "eE" and not seen_e:
                    nxt = self.sql[self.i + 1 : self.i + 2]
                    if nxt.isdigit() or (
                        nxt in "+-" and self.sql[self.i + 2 : self.i + 3].isdigit()
                    ):
                        seen_e = True
                        self._adv(2 if nxt in "+-" else 1)
                    else:
                        break
                else:
                    break
            return Token(T.NUMBER, self.sql[start : self.i], line, col)

        if c == "?":
            self._adv()
            return Token(T.PARAM, "?", line, col)
        if c == "$" and self.sql[self.i + 1 : self.i + 2].isdigit():
            start = self.i
            self._adv()
            while self.i < self.n and self.sql[self.i].isdigit():
                self._adv()
            return Token(T.PARAM, self.sql[start : self.i], line, col)

        singles = {
            "(": T.LPAREN, ")": T.RPAREN, ",": T.COMMA, ";": T.SEMI,
            ".": T.DOT, "[": T.LBRACKET, "]": T.RBRACKET,
        }
        if c in singles:
            self._adv()
            return Token(singles[c], c, line, col)

        for op in _OPS:
            if self.sql.startswith(op, self.i):
                self._adv(len(op))
                return Token(T.OP, "<>" if op == "!=" else op, line, col)

        self.error(f"unexpected character {c!r}")


def tokenize(sql: str) -> list[Token]:
    lx = Lexer(sql)
    out = []
    while True:
        t = lx.next_token()
        out.append(t)
        if t.type is T.EOF:
            return out
