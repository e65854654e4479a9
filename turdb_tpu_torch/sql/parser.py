"""Recursive-descent SQL parser with Pratt expression parsing.

Counterpart of reference src/sql/parser.rs (:5-35 recursive descent +
Pratt, arena AST; vector operators at mid precedence :907-909). Dialect:
the PostgreSQL-flavored subset in reference README.md:33-760 — DDL with
constraints and HNSW indexes, full DML with ON CONFLICT/RETURNING,
joins, CTEs, set ops, subqueries, window functions, vector/JSON
operators, transactions, EXPLAIN, PRAGMA.
"""

from __future__ import annotations

from turdb_tpu_torch.sql import ast as A
from turdb_tpu_torch.sql.lexer import SqlError, T, Token, tokenize

# Pratt binding powers (left bp, right bp implied +1 for left-assoc)
_BP = {
    "OR": 10,
    "AND": 20,
    # comparison
    "=": 40, "<>": 40, "<": 40, "<=": 40, ">": 40, ">=": 40,
    "@>": 40, "<@": 40, "&&": 40,
    "||": 50,
    "<->": 55, "<#>": 55, "<=>": 55,   # vector distances (parser.rs:907-909)
    "+": 60, "-": 60,
    "*": 70, "/": 70, "%": 70,
    "->": 90, "->>": 90,
}


class Parser:
    def __init__(self, sql: str):
        self.src = sql
        self.toks = tokenize(sql)
        self.pos = 0
        self._param_counter = 0
        self._anon_counter = 0

    # -- token helpers -----------------------------------------------------

    def peek(self, k: int = 0) -> Token:
        return self.toks[min(self.pos + k, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.peek()
        if t.type is not T.EOF:
            self.pos += 1
        return t

    def error(self, msg: str):
        t = self.peek()
        raise SqlError(f"{msg} (got {t.value!r})", t.line, t.col)

    def accept_kw(self, *names) -> bool:
        if self.peek().is_kw(*names):
            self.next()
            return True
        return False

    def expect_kw(self, *names):
        if not self.accept_kw(*names):
            self.error(f"expected {'/'.join(names)}")

    def _accept_word(self, *names) -> bool:
        """Accept a contextual (non-reserved) word: matches a KEYWORD or
        an IDENT whose uppercase form is in `names`."""
        t = self.peek()
        if t.type in (T.KEYWORD, T.IDENT) and t.value.upper() in names:
            self.next()
            return True
        return False

    def accept(self, ttype: T, value: str | None = None) -> bool:
        t = self.peek()
        if t.type is ttype and (value is None or t.value == value):
            self.next()
            return True
        return False

    def expect(self, ttype: T, value: str | None = None) -> Token:
        t = self.peek()
        if t.type is ttype and (value is None or t.value == value):
            return self.next()
        self.error(f"expected {value or ttype.value}")

    def ident(self) -> str:
        t = self.peek()
        if t.type is T.IDENT:
            return self.next().value
        # soft keywords usable as identifiers
        if t.type is T.KEYWORD and t.value in _SOFT_IDENT:
            return self.next().value.lower()
        self.error("expected identifier")

    def ident_any(self) -> str:
        # after an explicit AS, ANY keyword works as an alias (the
        # reference accepts "AS inner"/"AS outer"); no ambiguity exists
        # because AS was already consumed
        t = self.peek()
        if t.type in (T.IDENT, T.KEYWORD):
            v = self.next().value
            return v.lower() if t.type is T.KEYWORD else v
        self.error("expected identifier")

    # -- entry points ------------------------------------------------------

    def parse_statement(self):
        t = self.peek()
        if t.type is T.EOF:
            self.error("empty statement")
        stmt = self._statement()
        self.accept(T.SEMI)
        if self.peek().type is not T.EOF:
            self.error("unexpected trailing input")
        return stmt

    def parse_script(self) -> list:
        out = []
        while self.peek().type is not T.EOF:
            out.append(self._statement())
            while self.accept(T.SEMI):
                pass
        return out

    # -- statement dispatch ------------------------------------------------

    def _statement(self):
        t = self.peek()
        if t.is_kw("SELECT", "WITH") or t.type is T.LPAREN:
            return self._select_stmt()
        if t.is_kw("INSERT"):
            return self._insert()
        if t.is_kw("UPDATE"):
            return self._update()
        if t.is_kw("DELETE"):
            return self._delete()
        if t.is_kw("CREATE"):
            return self._create()
        if t.is_kw("DROP"):
            return self._drop()
        if t.is_kw("ALTER"):
            return self._alter()
        if t.is_kw("TRUNCATE"):
            self.next()
            self.accept_kw("TABLE")
            ref = self._table_ref()
            restart = False
            if self.peek().type is T.IDENT and \
                    self.peek().value.upper() in ("RESTART", "CONTINUE"):
                w = self.next().value.upper()
                nx = self.next()
                if not (nx.type is T.IDENT and nx.value.upper() == "IDENTITY"):
                    self.error("expected IDENTITY")
                restart = w == "RESTART"
            return A.Truncate(ref, restart)
        if t.is_kw("BEGIN", "START"):
            self.next()
            if self.peek().type is T.IDENT and self.peek().value.upper() in (
                    "DEFERRED", "IMMEDIATE", "EXCLUSIVE"):
                self.next()   # SQLite lock modes: single-writer MVCC here
            self.accept_kw("TRANSACTION", "WORK")
            # ISOLATION LEVEL ... / READ ONLY|WRITE (reference
            # parser.rs:2907; every level maps to snapshot isolation)
            iso = None
            ro = False
            while self.peek().type is T.IDENT and \
                    self.peek().value.upper() in ("ISOLATION", "READ"):
                w = self.next().value.upper()
                if w == "ISOLATION":
                    if self.ident().upper() != "LEVEL":
                        self.error("expected LEVEL")
                    parts = [self.ident().upper()]
                    if parts[0] in ("READ", "REPEATABLE"):
                        parts.append(self.ident().upper())
                    iso = " ".join(parts)
                else:
                    m = self.ident().upper()
                    if m == "ONLY":
                        ro = True
                    elif m != "WRITE":
                        self.error("expected ONLY or WRITE")
                self.accept(T.COMMA)
            return A.TxnStmt("BEGIN", read_only=ro, isolation=iso)
        if t.is_kw("COMMIT"):
            self.next()
            self.accept_kw("TRANSACTION", "WORK")
            return A.TxnStmt("COMMIT")
        if t.is_kw("ROLLBACK"):
            self.next()
            self.accept_kw("TRANSACTION", "WORK")
            if self.accept_kw("TO"):
                self.accept_kw("SAVEPOINT")
                return A.TxnStmt("ROLLBACK_TO", self.ident())
            return A.TxnStmt("ROLLBACK")
        if t.is_kw("SAVEPOINT"):
            self.next()
            return A.TxnStmt("SAVEPOINT", self.ident())
        if t.is_kw("RELEASE"):
            self.next()
            self.accept_kw("SAVEPOINT")
            return A.TxnStmt("RELEASE", self.ident())
        if t.is_kw("EXPLAIN"):
            self.next()
            analyze = False
            fmt = "text"
            if self.accept(T.LPAREN):
                # EXPLAIN (ANALYZE, VERBOSE, FORMAT JSON|TEXT) — the
                # reference's parenthesized option list (parser.rs:2977)
                while True:
                    if self.accept_kw("ANALYZE"):
                        analyze = True
                    elif self.accept_kw("VERBOSE"):
                        pass
                    elif self.peek().type is T.IDENT and \
                            self.peek().value.upper() == "FORMAT":
                        self.next()
                        fmt = self.ident().lower()
                        if fmt not in ("text", "json"):
                            self.error("expected TEXT or JSON")
                    else:
                        break
                    if not self.accept(T.COMMA):
                        break
                self.expect(T.RPAREN)
            else:
                analyze = self.accept_kw("ANALYZE")
                self.accept_kw("VERBOSE")
            return A.Explain(self._statement(), analyze, fmt)
        if t.is_kw("PRAGMA"):
            self.next()
            name = self.ident()
            value = None
            if self.accept(T.OP, "="):
                value = self._pragma_value()
            elif self.accept(T.LPAREN):
                value = self._pragma_value()
                self.expect(T.RPAREN)
            elif self.peek().type in (T.NUMBER, T.STRING, T.IDENT) or \
                    self.peek().is_kw("ON", "TRUE", "FALSE"):
                # bare-value form: PRAGMA WAL ON (reference pragma.rs)
                value = self._pragma_value()
            return A.Pragma(name, value)
        if t.is_kw("VACUUM"):
            self.next()
            self.accept_kw("ANALYZE")   # VACUUM ANALYZE = VACUUM here
            name = None
            if self.peek().type is T.IDENT:
                name = self.ident()
            return A.Vacuum(name)
        if t.is_kw("ANALYZE"):
            self.next()
            name = None
            if self.peek().type is T.IDENT:
                name = self.ident()
            return A.Analyze(name)
        if t.is_kw("SET"):
            # SET name { = | TO } value — executes via the PRAGMA
            # machinery (reference database.rs execute_set)
            self.next()
            # scopes (reference ast.rs:718 SetScope) — all map to the
            # single session of an embedded engine
            if not self.accept_kw("SESSION", "LOCAL"):
                if (self.peek().type is T.IDENT
                        and self.peek().value.upper() == "GLOBAL"
                        and self.peek(1).type is T.IDENT):
                    self.next()
            name = self.ident()
            if not self.accept(T.OP, "="):
                self.expect_kw("TO")
            return A.Pragma(name, self._pragma_value())
        if t.is_kw("SHOW"):
            self.next()
            if self.accept_kw("ALL"):     # SHOW ALL: every setting
                return A.Pragma("__show_all", None)
            return A.Pragma(self.ident(), None)
        if t.type is T.IDENT and t.value.upper() == "MERGE":
            return self._merge()
        if t.type is T.IDENT and t.value.upper() == "CALL":
            self.next()
            name = self.ident()
            schema = None
            if self.accept(T.DOT):
                schema, name = name, self.ident()
            self.expect(T.LPAREN)
            args = []
            if self.peek().type is not T.RPAREN:
                args = [self._expr()]
                while self.accept(T.COMMA):
                    args.append(self._expr())
            self.expect(T.RPAREN)
            return A.Call(name, schema, args)
        if t.type is T.IDENT and t.value.upper() in ("GRANT", "REVOKE"):
            return self._grant_revoke(self.next().value.upper())
        if t.type is T.IDENT and t.value.upper() == "RESET":
            # RESET name | RESET ALL (reference parser.rs:3069)
            self.next()
            if self.accept_kw("ALL"):
                return A.Pragma("__reset_all", None)
            return A.Pragma("__reset", self.ident())
        self.error("unknown statement")

    _PRIVILEGES = {"SELECT", "INSERT", "UPDATE", "DELETE", "TRUNCATE",
                   "REFERENCES", "TRIGGER", "CREATE", "CONNECT",
                   "TEMPORARY", "EXECUTE", "USAGE"}
    _GRANT_OBJECTS = {"TABLE", "SCHEMA", "DATABASE", "SEQUENCE", "FUNCTION",
                      "PROCEDURE", "TYPE", "DOMAIN", "VIEW"}

    def _grant_revoke(self, kind: str) -> A.Grant:
        """GRANT priv[, ...] ON [objtype] [name] TO grantee[, ...]
        [WITH GRANT OPTION] / REVOKE ... FROM ... [CASCADE|RESTRICT]
        (reference parser.rs:3125-3276)."""
        privs = []
        if self.peek().value.upper() == "ALL":
            self.next()
            if self.peek().value.upper() == "PRIVILEGES":
                self.next()
            privs.append("ALL")
        else:
            while True:
                w = self.next()
                pv = w.value.upper()
                if pv not in self._PRIVILEGES:
                    self.error(f"unknown privilege {w.value!r}")
                privs.append(pv)
                if not self.accept(T.COMMA):
                    break
        self.expect_kw("ON")
        obj_type = None
        if self.peek().value.upper() in self._GRANT_OBJECTS:
            obj_type = self.next().value.upper()
        term = "TO" if kind == "GRANT" else "FROM"
        obj_name = None
        if self.peek().value.upper() != term:
            obj_name = self.ident()
            if self.accept(T.DOT):
                obj_name = f"{obj_name}.{self.ident()}"
        if self.next().value.upper() != term:
            self.error(f"expected {term}")
        grantees = [self.ident()]
        while self.accept(T.COMMA):
            grantees.append(self.ident())
        grant_option = cascade = False
        if kind == "GRANT" and self.accept_kw("WITH"):
            if self.ident().upper() != "GRANT":
                self.error("expected GRANT after WITH")
            if self.ident().upper() != "OPTION":
                self.error("expected OPTION")
            grant_option = True
        if kind == "REVOKE":
            nx = self.peek()
            if nx.value.upper() in ("CASCADE", "RESTRICT"):
                cascade = self.next().value.upper() == "CASCADE"
        return A.Grant(kind, privs, obj_type, obj_name, grantees,
                       grant_option, cascade)

    def _create_trigger(self, or_replace: bool) -> A.CreateTrigger:
        self.next()                         # TRIGGER (identifier keyword)
        name = self.ident()
        t = self.peek()
        if t.type is T.IDENT and t.value.upper() in ("BEFORE", "AFTER"):
            timing = self.next().value.upper()
        elif t.type is T.IDENT and t.value.upper() == "INSTEAD":
            # INSTEAD OF <event> ON <view> — view DML redirection
            self.next()
            if self.ident().upper() != "OF":
                self.error("expected OF after INSTEAD")
            timing = "INSTEAD OF"
        else:
            self.error("expected BEFORE, AFTER or INSTEAD OF")
        events = []
        while True:
            ev = self.next()
            if not ev.is_kw("INSERT", "UPDATE", "DELETE"):
                self.error("expected INSERT/UPDATE/DELETE")
            events.append(ev.value)
            if not self.accept_kw("OR"):
                break
        self.expect_kw("ON")
        table = self.ident()
        level = "ROW"
        if self.accept_kw("FOR"):
            if self.ident().upper() != "EACH":
                self.error("expected EACH")
            level = self.ident().upper()
            if level not in ("ROW", "STATEMENT"):
                self.error("expected ROW or STATEMENT")
        when = None
        if self.accept_kw("WHEN"):
            self.expect(T.LPAREN)
            w0 = self.peek().off
            self._expr()
            when = self.src[w0:self.peek().off].strip()
            self.expect(T.RPAREN)
        body = []
        nx = self.peek()
        if nx.type is T.IDENT and nx.value.upper() == "EXECUTE":
            # reference form: EXECUTE FUNCTION f() — call the UDF per row
            self.next()
            w = self.ident().upper()
            if w not in ("FUNCTION", "PROCEDURE"):
                self.error("expected FUNCTION/PROCEDURE")
            fname = self.ident()
            self.expect(T.LPAREN)
            self.expect(T.RPAREN)
            body = [f"SELECT {fname}()"]
        elif nx.is_kw("BEGIN"):
            # SQLite-style body: BEGIN <stmt>; [<stmt>;]* END
            self.next()
            while not self.peek().is_kw("END"):
                s0 = self.peek().off
                self._statement()
                body.append(self.src[s0:self.peek().off].strip())
                if not self.accept(T.SEMI):
                    break
            self.expect_kw("END")
        else:
            self.error("expected BEGIN or EXECUTE FUNCTION")
        if not body:
            self.error("trigger body is empty")
        return A.CreateTrigger(name, table, timing, events, body, when,
                               or_replace, level)

    def _create_procedure(self, or_replace: bool) -> A.CreateProcedure:
        self.next()                         # PROCEDURE (identifier keyword)
        name = self.ident()
        schema = None
        if self.accept(T.DOT):
            schema, name = name, self.ident()
        self.expect(T.LPAREN)
        params = []
        if self.peek().type is not T.RPAREN:
            while True:
                pn = self.ident()
                tn, _tp = self._type_name()
                params.append((pn, tn))
                if not self.accept(T.COMMA):
                    break
        self.expect(T.RPAREN)
        self.expect_kw("AS")
        body = self.expect(T.STRING).value
        lang = "sql"
        if self.peek().type is T.IDENT and \
                self.peek().value.upper() == "LANGUAGE":
            self.next()
            lang = self.ident().lower()
        return A.CreateProcedure(name, schema, params, body, lang,
                                 or_replace)

    def _create_function(self, or_replace: bool) -> A.CreateFunction:
        self.next()                         # FUNCTION (identifier keyword)
        name = self.ident()
        schema = None
        if self.accept(T.DOT):
            schema, name = name, self.ident()
        self.expect(T.LPAREN)
        params = []
        if self.peek().type is not T.RPAREN:
            while True:
                pn = self.ident()
                tn, _tp = self._type_name()
                params.append((pn, tn))
                if not self.accept(T.COMMA):
                    break
        self.expect(T.RPAREN)
        if self.peek().type is not T.IDENT or \
                self.peek().value.upper() != "RETURNS":
            self.error("expected RETURNS")
        self.next()
        rt, _ = self._type_name()
        self.expect_kw("AS")
        body = self.expect(T.STRING).value
        lang = "sql"
        if self.peek().type is T.IDENT and \
                self.peek().value.upper() == "LANGUAGE":
            self.next()
            lang = self.ident().lower()
        return A.CreateFunction(name, schema, params, rt, body, lang,
                                or_replace)

    def _merge(self) -> A.Merge:
        self.next()                       # MERGE (identifier keyword)
        self.expect_kw("INTO")
        target = self._table_ref(allow_alias=True)
        self.expect_kw("USING")
        source = self._table_factor()     # table [alias] or (SELECT...) alias
        self.expect_kw("ON")
        on = self._expr()
        clauses = []
        while self.accept_kw("WHEN"):
            neg = self.accept_kw("NOT")
            if self.ident().upper() != "MATCHED":
                self.error("expected MATCHED")
            self.expect_kw("THEN")
            if neg:
                self.expect_kw("INSERT")
                cols = None
                if self.accept(T.LPAREN):
                    cols = [self.ident()]
                    while self.accept(T.COMMA):
                        cols.append(self.ident())
                    self.expect(T.RPAREN)
                self.expect_kw("VALUES")
                self.expect(T.LPAREN)
                vals = [self._expr()]
                while self.accept(T.COMMA):
                    vals.append(self._expr())
                self.expect(T.RPAREN)
                clauses.append(("insert", cols, vals))
            elif self.accept_kw("UPDATE"):
                self.expect_kw("SET")
                sets = [self._assignment()]
                while self.accept(T.COMMA):
                    sets.append(self._assignment())
                clauses.append(("update", sets))
            elif self.accept_kw("DELETE"):
                clauses.append(("delete",))
            else:
                self.error("expected UPDATE/DELETE/INSERT in MERGE clause")
        if not clauses:
            self.error("MERGE requires at least one WHEN clause")
        return A.Merge(target, source, on, clauses)

    def _pragma_value(self):
        t = self.peek()
        if t.type is T.NUMBER:
            self.next()
            return _num(t.value)
        if t.type is T.STRING:
            self.next()
            return t.value
        if t.is_kw("TRUE"):
            self.next()
            return True
        if t.is_kw("FALSE"):
            self.next()
            return False
        if t.is_kw("ON"):
            self.next()
            return True
        # any keyword works as a bare pragma value (PRAGMA synchronous =
        # FULL: FULL lexes as the join keyword — reference pragma.rs
        # parses the value as raw text)
        if t.type is T.KEYWORD:
            return self.next().value.lower()
        return self.ident()

    # -- SELECT ------------------------------------------------------------

    def _select_stmt(self) -> A.Select:
        ctes = []
        if self.accept_kw("WITH"):
            recursive = self.accept_kw("RECURSIVE")
            while True:
                name = self.ident()
                cols = None
                if self.accept(T.LPAREN):
                    cols = [self.ident()]
                    while self.accept(T.COMMA):
                        cols.append(self.ident())
                    self.expect(T.RPAREN)
                self.expect_kw("AS")
                self.expect(T.LPAREN)
                q = self._select_stmt()
                self.expect(T.RPAREN)
                ctes.append(A.CTE(name, q, cols, recursive))
                if not self.accept(T.COMMA):
                    break
        sel = self._select_core()
        sel.ctes = ctes
        # set operations
        while self.peek().is_kw("UNION", "INTERSECT", "EXCEPT"):
            op = self.next().value
            all_ = self.accept_kw("ALL")
            self.accept_kw("DISTINCT")
            rhs = self._select_core_or_paren()
            sel = self._wrap_setop(sel, op, all_, rhs)
        # trailing ORDER BY/LIMIT bind to the set-op result
        if self.peek().is_kw("ORDER"):
            sel.order_by = self._order_by()
        if self.accept_kw("LIMIT"):
            if not self.accept_kw("ALL"):
                sel.limit = self._expr()
            if self.accept(T.COMMA):  # LIMIT off, n (MySQL-style)
                sel.offset = sel.limit
                sel.limit = self._expr()
        if self.accept_kw("OFFSET"):
            sel.offset = self._expr()
            self._accept_word("ROW", "ROWS")   # standard OFFSET n ROWS
        self._fetch_clause(sel)
        if self.accept_kw("FOR"):
            sel.for_update = self._lock_clause()
        return sel

    def _fetch_clause(self, sel):
        """SQL-standard FETCH {FIRST|NEXT} [n] {ROW|ROWS} ONLY."""
        if not self._accept_word("FETCH"):
            return
        if not self._accept_word("FIRST", "NEXT"):
            self.error("expected FIRST or NEXT after FETCH")
        t = self.peek()
        if t.type in (T.NUMBER, T.PARAM):
            sel.limit = self._expr()
        else:
            sel.limit = A.Literal(1)     # FETCH FIRST ROW ONLY
        if not self._accept_word("ROW", "ROWS"):
            self.error("expected ROW or ROWS in FETCH clause")
        if not self._accept_word("ONLY"):
            self.error("expected ONLY in FETCH clause (WITH TIES "
                       "is not supported)")

    def _lock_clause(self) -> A.LockClause:
        """FOR {UPDATE | NO KEY UPDATE | SHARE | KEY SHARE} [OF t, ..]
        [NOWAIT | SKIP LOCKED] (reference parser.rs:505-560)."""

        def word(*names):
            t = self.peek()
            if (t.type is T.IDENT and t.value.upper() in names) or (
                t.type is T.KEYWORD and t.value in names
            ):
                self.next()
                return True
            return False

        lc = A.LockClause()
        if word("UPDATE"):
            lc.mode = "update"
        elif word("SHARE"):
            lc.mode = "share"
        elif word("NO"):
            if not (word("KEY") and word("UPDATE")):
                self.error("expected KEY UPDATE after FOR NO")
            lc.mode = "no key update"
        elif word("KEY"):
            if not word("SHARE"):
                self.error("expected SHARE after FOR KEY")
            lc.mode = "key share"
        else:
            self.error("expected UPDATE, SHARE, NO KEY UPDATE, "
                       "or KEY SHARE after FOR")
        if word("OF"):
            lc.tables = [self.expect(T.IDENT).value]
            while self.accept(T.COMMA):
                lc.tables.append(self.expect(T.IDENT).value)
        if word("NOWAIT"):
            lc.policy = "nowait"
        elif word("SKIP"):
            if not word("LOCKED"):
                self.error("expected LOCKED after SKIP")
            lc.policy = "skip locked"
        return lc

    def _wrap_setop(self, lhs, op, all_, rhs):
        # chain onto lhs: (lhs op rhs); nesting left-assoc
        if lhs.set_op is None and not lhs.order_by and lhs.limit is None:
            lhs.set_op = (op, all_, rhs)
            return lhs
        outer = A.Select(items=[A.SelectItem(A.Star())], from_=A.SubqueryRef(lhs, "_s"))
        outer.set_op = (op, all_, rhs)
        return outer

    def _select_core_or_paren(self) -> A.Select:
        if self.accept(T.LPAREN):
            s = self._select_stmt()
            self.expect(T.RPAREN)
            return s
        # a set-op arm must not swallow the trailing ORDER BY/LIMIT, which
        # bind to the whole set-op result (PostgreSQL semantics)
        return self._select_core(no_tail=True)

    def _select_core(self, no_tail: bool = False) -> A.Select:
        if self.accept(T.LPAREN):
            s = self._select_stmt()
            self.expect(T.RPAREN)
            return s
        self.expect_kw("SELECT")
        sel = A.Select()
        if self.accept_kw("DISTINCT"):
            if self.accept_kw("ON"):
                # DISTINCT ON (exprs): first row per key in ORDER BY
                # order (reference ast.rs:157 Distinct::DistinctOn)
                self.expect(T.LPAREN)
                sel.distinct_on = [self._expr()]
                while self.accept(T.COMMA):
                    sel.distinct_on.append(self._expr())
                self.expect(T.RPAREN)
            else:
                sel.distinct = True
        else:
            self.accept_kw("ALL")
        sel.items = [self._select_item()]
        while self.accept(T.COMMA):
            sel.items.append(self._select_item())
        if self.accept_kw("FROM"):
            sel.from_ = self._table_expr()
        if self.accept_kw("WHERE"):
            sel.where = self._expr()
        if self.accept_kw("GROUP"):
            self.expect_kw("BY")
            self._group_by_list(sel)
        if self.accept_kw("HAVING"):
            sel.having = self._expr()
        windows = None
        if (self.peek().type is T.IDENT
                and self.peek().value.upper() == "WINDOW"
                and self.peek(2).is_kw("AS")):
            # WINDOW w AS (spec) [, ...] — named windows (SQLite/
            # PostgreSQL surface; not in the reference's grammar)
            self.next()
            windows = {}
            while True:
                wname = self.ident().lower()
                self.expect_kw("AS")
                self.expect(T.LPAREN)
                windows[wname] = self._window_spec_body()
                self.expect(T.RPAREN)
                if not self.accept(T.COMMA):
                    break
        if no_tail:
            if windows is not None or getattr(self, "_over_names", False):
                _resolve_named_windows(sel, windows)
            return sel
        if self.peek().is_kw("ORDER"):
            sel.order_by = self._order_by()
        if self.accept_kw("LIMIT"):
            if not self.accept_kw("ALL"):
                sel.limit = self._expr()
            if self.accept(T.COMMA):
                sel.offset = sel.limit
                sel.limit = self._expr()
        if self.accept_kw("OFFSET"):
            sel.offset = self._expr()
            self._accept_word("ROW", "ROWS")   # standard OFFSET n ROWS
        self._fetch_clause(sel)
        if windows is not None or getattr(self, "_over_names", False):
            # the reflective AST walk only runs when a WINDOW clause or
            # an `OVER name` reference actually appeared
            _resolve_named_windows(sel, windows)
        return sel

    def _group_by_list(self, sel):
        """GROUP BY items: plain exprs mixed with ROLLUP(..) / CUBE(..) /
        GROUPING SETS((..), ..) (reference lexes these keywords,
        lexer.rs:421-476, but never parses them; PostgreSQL 7.2.4
        semantics). Constructs compose by cross product; the expansion
        is stored as sel.grouping_sets with sel.group_by = full key
        list."""
        import itertools

        def gb_item():
            t = self.peek()
            if (t.type is T.IDENT and t.value.upper() in ("ROLLUP", "CUBE")
                    and self.peek(1).type is T.LPAREN):
                kind = t.value.upper()
                self.next()
                self.next()
                exprs = [self._expr()]
                while self.accept(T.COMMA):
                    exprs.append(self._expr())
                self.expect(T.RPAREN)
                if kind == "ROLLUP":
                    sets = [exprs[:k] for k in range(len(exprs), -1, -1)]
                else:   # CUBE: every subset, larger first
                    sets = [
                        [e for j, e in enumerate(exprs) if m & (1 << j)]
                        for m in sorted(
                            range(1 << len(exprs)),
                            key=lambda m: -bin(m).count("1"),
                        )
                    ]
                return ("sets", sets)
            if (t.type is T.IDENT and t.value.upper() == "GROUPING"
                    and self.peek(1).type is T.IDENT
                    and self.peek(1).value.upper() == "SETS"):
                self.next()
                self.next()
                self.expect(T.LPAREN)
                sets = []
                while True:
                    if self.accept(T.LPAREN):
                        s = []
                        if self.peek().type is not T.RPAREN:
                            s = [self._expr()]
                            while self.accept(T.COMMA):
                                s.append(self._expr())
                        self.expect(T.RPAREN)
                    else:
                        s = [self._expr()]
                    sets.append(s)
                    if not self.accept(T.COMMA):
                        break
                self.expect(T.RPAREN)
                return ("sets", sets)
            return ("expr", self._expr())

        items = [gb_item()]
        while self.accept(T.COMMA):
            items.append(gb_item())
        plain = [v for k, v in items if k == "expr"]
        constructs = [v for k, v in items if k == "sets"]
        if not constructs:
            sel.group_by = plain
            return
        full, seen = list(plain), {A.render_expr(e) for e in plain}
        for c in constructs:
            for s in c:
                for e in s:
                    r = A.render_expr(e)
                    if r not in seen:
                        seen.add(r)
                        full.append(e)
        sets = []
        for combo in itertools.product(*constructs):
            s, sr = list(plain), {A.render_expr(e) for e in plain}
            for part in combo:
                for e in part:
                    r = A.render_expr(e)
                    if r not in sr:
                        sr.add(r)
                        s.append(e)
            sets.append(s)
        sel.group_by = full
        sel.grouping_sets = sets

    def _order_by(self):
        self.expect_kw("ORDER")
        self.expect_kw("BY")
        items = [self._order_item()]
        while self.accept(T.COMMA):
            items.append(self._order_item())
        return items

    def _order_item(self) -> A.OrderItem:
        e = self._expr()
        desc = False
        if self.accept_kw("DESC"):
            desc = True
        else:
            self.accept_kw("ASC")
        nulls_last = None
        if self.accept_kw("NULLS"):
            if self.accept_kw("LAST"):
                nulls_last = True
            else:
                self.expect_kw("FIRST")
                nulls_last = False
        return A.OrderItem(e, desc, nulls_last)

    def _select_item(self) -> A.SelectItem:
        t = self.peek()
        if t.type is T.OP and t.value == "*":
            self.next()
            return A.SelectItem(A.Star())
        # table.*
        if (
            t.type in (T.IDENT,)
            and self.peek(1).type is T.DOT
            and self.peek(2).type is T.OP
            and self.peek(2).value == "*"
        ):
            self.next(); self.next(); self.next()
            return A.SelectItem(A.Star(table=t.value))
        e = self._expr()
        alias = None
        if self.accept_kw("AS"):
            alias = self.ident()
        elif self.peek().type is T.IDENT and not self._at_window_clause():
            alias = self.ident()
        return A.SelectItem(e, alias)

    # -- FROM / joins ------------------------------------------------------

    def _table_expr(self):
        left = self._table_factor()
        while True:
            t = self.peek()
            natural = False
            if t.is_kw("NATURAL"):
                natural = True
                self.next()
                t = self.peek()
            if t.is_kw("JOIN", "INNER"):
                self.accept_kw("INNER")
                self.expect_kw("JOIN")
                kind = "INNER"
            elif t.is_kw("LEFT"):
                self.next()
                self.accept_kw("OUTER")
                self.expect_kw("JOIN")
                kind = "LEFT"
            elif t.is_kw("RIGHT"):
                self.next()
                self.accept_kw("OUTER")
                self.expect_kw("JOIN")
                kind = "RIGHT"
            elif t.is_kw("FULL"):
                self.next()
                self.accept_kw("OUTER")
                self.expect_kw("JOIN")
                kind = "FULL"
            elif t.is_kw("CROSS"):
                self.next()
                self.expect_kw("JOIN")
                kind = "CROSS"
            elif t.type is T.COMMA:
                self.next()
                right = self._table_factor()
                left = A.Join(left, right, "CROSS")
                continue
            else:
                return left
            right = self._table_factor()
            on = None
            using = None
            if not natural and kind != "CROSS":
                if self.accept_kw("ON"):
                    on = self._expr()
                elif self.accept_kw("USING"):
                    self.expect(T.LPAREN)
                    using = [self.ident()]
                    while self.accept(T.COMMA):
                        using.append(self.ident())
                    self.expect(T.RPAREN)
            left = A.Join(left, right, kind, on, using, natural)

    def _table_factor(self):
        lateral = False
        if (self.peek().type is T.IDENT
                and self.peek().value.upper() == "LATERAL"
                and self.peek(1).type is T.LPAREN):
            # LATERAL (SELECT ...) — reference parses it (parser.rs:743)
            # but bails at planning (planner/select.rs:382); executes here
            self.next()
            lateral = True
        if self.accept(T.LPAREN):
            if self.peek().is_kw("SELECT", "WITH"):
                sub = self._select_stmt()
                self.expect(T.RPAREN)
                if self.accept_kw("AS"):
                    alias = self.ident_any()
                elif (self.peek().type is T.IDENT
                      and not self._at_window_clause()) or (
                        self.peek().type is T.KEYWORD and
                        self.peek().value in _SOFT_IDENT):
                    alias = self.ident()
                else:
                    # alias optional (reference accepts bare derived
                    # tables); synthesize a per-statement unique name.
                    # The FIRST unaliased lateral keeps the reference's
                    # default alias "lateral" (parser.rs:748); later ones
                    # get unique names so qualified refs can't collide
                    self._anon_counter += 1
                    if lateral and not getattr(self, "_lateral_seen", False):
                        self._lateral_seen = True
                        alias = "lateral"
                    elif lateral:
                        alias = f"lateral{self._anon_counter}"
                    else:
                        alias = f"_subquery{self._anon_counter}"
                return A.SubqueryRef(sub, alias, lateral)
            if lateral:
                self.error("expected SELECT after LATERAL (")
            inner = self._table_expr()
            self.expect(T.RPAREN)
            return inner
        t = self.peek()
        if (t.type is T.IDENT and t.value.upper() == "UNNEST"
                and self.peek(1).type is T.LPAREN):
            self.next()
            self.next()
            args = [self._expr()]
            while self.accept(T.COMMA):
                args.append(self._expr())
            self.expect(T.RPAREN)
            tf = A.TableFunc("unnest", args)
            if self.accept_kw("WITH"):
                if self.ident().upper() != "ORDINALITY":
                    self.error("expected ORDINALITY after WITH")
                tf.ordinality = True
            if self.accept_kw("AS"):
                tf.alias = self.ident_any()
            elif self.peek().type is T.IDENT and not self._at_window_clause():
                tf.alias = self.ident()
            if tf.alias is not None and self.accept(T.LPAREN):
                tf.col_aliases = [self.ident()]
                while self.accept(T.COMMA):
                    tf.col_aliases.append(self.ident())
                self.expect(T.RPAREN)
            return tf
        return self._table_ref(allow_alias=True)

    def _table_ref(self, allow_alias: bool = False) -> A.TableRef:
        name = self.ident()
        schema = None
        if self.accept(T.DOT):
            schema, name = name, self.ident()
        alias = None
        sample = None
        if allow_alias:
            if self.accept_kw("AS"):
                alias = self.ident_any()
            elif (self.peek().type is T.IDENT
                  and self.peek().value.upper() != "TABLESAMPLE"
                  and not self._at_window_clause()):
                alias = self.ident()
        if (self.peek().type is T.IDENT
                and self.peek().value.upper() == "TABLESAMPLE"):
            self.next()
            m = self.ident().upper()
            if m not in ("BERNOULLI", "SYSTEM"):
                self.error("expected BERNOULLI or SYSTEM after TABLESAMPLE")
            self.expect(T.LPAREN)
            pct = float(self.expect(T.NUMBER).value)
            self.expect(T.RPAREN)
            seed = None
            if (self.peek().type is T.IDENT
                    and self.peek().value.upper() == "REPEATABLE"):
                self.next()
                self.expect(T.LPAREN)
                seed = int(float(self.expect(T.NUMBER).value))
                self.expect(T.RPAREN)
            if not 0.0 <= pct <= 100.0:
                self.error("TABLESAMPLE percentage must be in [0, 100]")
            sample = A.TableSample(m.lower(), pct, seed)
        return A.TableRef(name, schema, alias, sample)

    def _at_window_clause(self) -> bool:
        """True at the start of `WINDOW w AS (...)` — implicit-alias
        positions (table refs, derived tables, select items) must not
        read WINDOW as an alias."""
        return (
            self.peek().value.upper() == "WINDOW"
            and self.peek(1).type is T.IDENT
            and self.peek(2).is_kw("AS")
        )

    # -- INSERT / UPDATE / DELETE -----------------------------------------

    def _insert(self) -> A.Insert:
        self.expect_kw("INSERT")
        self.expect_kw("INTO")
        table = self._table_ref()
        cols = None
        if self.peek().type is T.LPAREN:
            self.next()
            cols = [self.ident()]
            while self.accept(T.COMMA):
                cols.append(self.ident())
            self.expect(T.RPAREN)
        values = None
        query = None
        if self.accept_kw("VALUES"):
            values = [self._value_row()]
            while self.accept(T.COMMA):
                values.append(self._value_row())
        elif self.accept_kw("DEFAULT"):
            # INSERT INTO t DEFAULT VALUES (reference parser.rs:1602)
            self.expect_kw("VALUES")
            if cols:
                self.error("DEFAULT VALUES takes no column list")
            cols = []
            values = [[]]
        elif self.peek().is_kw("SELECT", "WITH"):
            query = self._select_stmt()
        else:
            self.error("expected VALUES, DEFAULT VALUES, or SELECT")
        on_conflict = None
        if self.accept_kw("ON"):
            self.expect_kw("CONFLICT")
            conflict_cols = None
            if self.accept(T.LPAREN):
                conflict_cols = [self.ident()]
                while self.accept(T.COMMA):
                    conflict_cols.append(self.ident())
                self.expect(T.RPAREN)
            elif self.accept_kw("ON"):
                # ON CONFLICT ON CONSTRAINT name (reference
                # OnConflictTarget::Constraint): resolved to the named
                # unique index/constraint's columns at execution
                self.expect_kw("CONSTRAINT")
                conflict_cols = ("constraint", self.ident())
            self.expect_kw("DO")
            if self.accept_kw("NOTHING"):
                on_conflict = (conflict_cols, "NOTHING")
            else:
                self.expect_kw("UPDATE")
                self.expect_kw("SET")
                sets = [self._assignment()]
                while self.accept(T.COMMA):
                    sets.append(self._assignment())
                on_conflict = (conflict_cols, sets)
        returning = self._returning()
        return A.Insert(table, cols, values, query, on_conflict, returning)

    def _value_row(self):
        self.expect(T.LPAREN)
        row = [self._expr()]
        while self.accept(T.COMMA):
            row.append(self._expr())
        self.expect(T.RPAREN)
        return row

    def _assignment(self):
        col = self.ident()
        self.expect(T.OP, "=")
        return (col, self._expr())

    def _returning(self):
        if not self.accept_kw("RETURNING"):
            return None
        items = [self._select_item()]
        while self.accept(T.COMMA):
            items.append(self._select_item())
        return items

    def _update(self) -> A.Update:
        self.expect_kw("UPDATE")
        table = self._table_ref(allow_alias=True)
        self.expect_kw("SET")
        sets = [self._assignment()]
        while self.accept(T.COMMA):
            sets.append(self._assignment())
        from_ = None
        if self.accept_kw("FROM"):
            from_ = self._table_expr()
        where = self._expr() if self.accept_kw("WHERE") else None
        returning = self._returning()
        return A.Update(table, sets, from_, where, returning)

    def _delete(self) -> A.Delete:
        self.expect_kw("DELETE")
        self.expect_kw("FROM")
        table = self._table_ref(allow_alias=True)
        using = self._table_expr() if self.accept_kw("USING") else None
        where = self._expr() if self.accept_kw("WHERE") else None
        returning = self._returning()
        return A.Delete(table, where, returning, using)

    # -- DDL ---------------------------------------------------------------

    def _create(self):
        self.expect_kw("CREATE")
        if self.accept_kw("SCHEMA"):
            ine = self._if_not_exists()
            return A.CreateSchema(self.ident(), ine)
        or_replace = False
        if self.accept_kw("OR"):
            self.expect_kw("REPLACE")
            or_replace = True
        self.accept_kw("MATERIALIZED")   # executed as a plain view
        if self.accept_kw("VIEW"):
            return self._create_view(or_replace)
        if self.peek().type is T.IDENT and \
                self.peek().value.upper() == "FUNCTION":
            return self._create_function(or_replace)
        if self.peek().type is T.IDENT and \
                self.peek().value.upper() == "TRIGGER":
            return self._create_trigger(or_replace)
        if self.peek().type is T.IDENT and \
                self.peek().value.upper() == "PROCEDURE":
            return self._create_procedure(or_replace)
        if or_replace:
            self.error(
                "expected VIEW/FUNCTION/PROCEDURE/TRIGGER after OR REPLACE"
            )
        if self.peek().type is T.IDENT and \
                self.peek().value.upper() in ("TYPE", "DOMAIN"):
            self.next()
            name = self.ident()
            schema = None
            if self.accept(T.DOT):
                schema, name = name, self.ident()
            self.expect_kw("AS")
            if self.peek().type is not T.LPAREN and not (
                    self.peek().type is T.IDENT and
                    self.peek().value.upper() == "ENUM"):
                # CREATE DOMAIN-shaped: AS <base type> (reference
                # parse_create_domain maps to CreateType too)
                tn, tp = self._type_name()
                return A.CreateType(name, schema, "domain", [tn, tp])
            if self.peek().type is T.IDENT and \
                    self.peek().value.upper() == "ENUM":
                self.next()
                self.expect(T.LPAREN)
                vals = [self.expect(T.STRING).value]
                while self.accept(T.COMMA):
                    vals.append(self.expect(T.STRING).value)
                self.expect(T.RPAREN)
                return A.CreateType(name, schema, "enum", vals)
            self.expect(T.LPAREN)
            fields = []
            while True:
                fn = self.ident()
                tn, tp = self._type_name()
                fields.append((fn, tn, tp))
                if not self.accept(T.COMMA):
                    break
            self.expect(T.RPAREN)
            return A.CreateType(name, schema, "composite", fields)
        temporary = False
        if (self.peek().type is T.IDENT
                and self.peek().value.upper() in ("TEMP", "TEMPORARY")):
            self.next()
            temporary = True
        unique = self.accept_kw("UNIQUE")
        if self.accept_kw("INDEX"):
            ine = self._if_not_exists()
            name = self.ident()
            self.expect_kw("ON")
            table = self._table_ref()
            using = None
            if self.accept_kw("USING"):
                using = self.ident().upper()
            self.expect(T.LPAREN)
            cols = [self._index_col()]
            while self.accept(T.COMMA):
                cols.append(self._index_col())
            self.expect(T.RPAREN)
            if using is None and self.accept_kw("USING"):
                using = self.ident().upper()
            options = {}
            if self.accept_kw("WITH"):
                self.expect(T.LPAREN)
                while True:
                    k = self.ident()
                    self.expect(T.OP, "=")
                    v = self._pragma_value()
                    options[k] = v
                    if not self.accept(T.COMMA):
                        break
                self.expect(T.RPAREN)
            where = where_text = None
            if self.peek().is_kw("WHERE"):
                # partial index (reference table.rs:273 where_clause;
                # ddl.rs:452): keep the predicate source text for the
                # catalog alongside the parsed expr
                self.next()
                start = self.peek().off
                where = self._expr()
                where_text = self.src[start:self.peek().off].strip() \
                    .rstrip(";").strip()
            return A.CreateIndex(name, table, cols, unique, using, options,
                                 ine, where, where_text)
        if unique:
            self.error("expected INDEX after UNIQUE")
        self.expect_kw("TABLE")
        ine = self._if_not_exists()
        table = self._table_ref()
        self.expect(T.LPAREN)
        columns, constraints = [], []
        while True:
            if self.peek().is_kw("PRIMARY", "UNIQUE", "CHECK", "FOREIGN", "CONSTRAINT"):
                constraints.append(self._table_constraint())
            else:
                columns.append(self._column_spec())
            if not self.accept(T.COMMA):
                break
        self.expect(T.RPAREN)
        return A.CreateTable(table, columns, constraints, ine, temporary)

    def _create_view(self, or_replace: bool) -> A.CreateView:
        """CREATE [OR REPLACE] [MATERIALIZED] VIEW name [(cols)] AS select
        (reference parser.rs:2132 parse_create_view; here views also
        EXECUTE — the body text is sliced from the source via token
        offsets and persisted in the catalog)."""
        ine = self._if_not_exists()
        name = self.ident()
        schema = None
        if self.accept(T.DOT):
            schema, name = name, self.ident()
        columns = None
        if self.accept(T.LPAREN):
            columns = [self.ident()]
            while self.accept(T.COMMA):
                columns.append(self.ident())
            self.expect(T.RPAREN)
        self.expect_kw("AS")
        start = self.peek().off
        query = self._select_stmt()
        body = self.src[start:self.peek().off].rstrip().rstrip(";").rstrip()
        return A.CreateView(name, query, body, schema, columns,
                            or_replace, ine)

    def _if_not_exists(self) -> bool:
        if self.accept_kw("IF"):
            self.expect_kw("NOT")
            self.expect_kw("EXISTS")
            return True
        return False

    def _index_col(self):
        e = self._expr()
        desc = bool(self.accept_kw("DESC"))
        if not desc:
            self.accept_kw("ASC")
        return (e, desc)

    def _type_name(self):
        t = self.peek()
        if t.type is T.KEYWORD and t.value in (
            "DATE", "TIME", "TIMESTAMP", "INTERVAL", "VECTOR",
        ):
            self.next()
            name = t.value
        else:
            name = self.ident().upper()
        if name == "DOUBLE" and self.peek().type is T.IDENT and \
                self.peek().value.upper() == "PRECISION":
            self.next()
        if name == "CHARACTER" and self.peek().type is T.IDENT and \
                self.peek().value.upper() == "VARYING":
            self.next()
            name = "VARCHAR"
        params = []
        if self.accept(T.LPAREN):
            while True:
                if self.peek().type is T.STRING:
                    # inline enum labels: ENUM('a','b','c')
                    params.append(self.next().value)
                else:
                    params.append(_num(self.expect(T.NUMBER).value))
                if not self.accept(T.COMMA):
                    break
            self.expect(T.RPAREN)
        # TEXT[] style arrays
        if self.accept(T.LBRACKET):
            self.expect(T.RBRACKET)
            params = [name] + params
            name = "ARRAY"
        return name, params

    def _column_spec(self) -> A.ColumnSpec:
        name = self.ident()
        type_name, params = self._type_name()
        spec = A.ColumnSpec(name, type_name, params)
        while True:
            if self.accept_kw("NOT"):
                self.expect_kw("NULL")
                spec.not_null = True
            elif self.accept_kw("NULL"):
                pass
            elif self.accept_kw("PRIMARY"):
                self.expect_kw("KEY")
                spec.primary_key = True
                spec.not_null = True
            elif self.accept_kw("UNIQUE"):
                spec.unique = True
            elif self.accept_kw("DEFAULT"):
                spec.default = self._expr(_BP["OR"] + 1)
            elif self.accept_kw("CHECK"):
                self.expect(T.LPAREN)
                spec.check = self._expr()
                self.expect(T.RPAREN)
            elif self.accept_kw("REFERENCES"):
                rt = self.ident()
                rc = None
                if self.accept(T.LPAREN):
                    rc = self.ident()
                    self.expect(T.RPAREN)
                od, ou = self._fk_actions()
                spec.references = (rt, rc, od, ou)
            elif self.accept_kw("COLLATE"):
                self.ident()
            elif self.peek().type is T.IDENT and self.peek().value.upper() in (
                    "AUTO_INCREMENT", "AUTOINCREMENT"):
                # MySQL/SQLite spellings; reference persists the counter in
                # its TableFileHeader (file_manager.rs:49-60)
                self.next()
                spec.auto_increment = True
            else:
                break
        return spec

    def _fk_actions(self):
        on_delete = on_update = None
        while self.accept_kw("ON"):
            which = self.next().value  # DELETE or UPDATE keyword token
            action = self._fk_action()
            if which == "DELETE":
                on_delete = action
            else:
                on_update = action
        return on_delete, on_update

    def _fk_action(self) -> str:
        if self.accept_kw("CASCADE"):
            return "CASCADE"
        if self.accept_kw("RESTRICT"):
            return "RESTRICT"
        if self.accept_kw("SET"):
            if self.accept_kw("NULL"):
                return "SET NULL"
            self.expect_kw("DEFAULT")
            return "SET DEFAULT"
        if self.peek().type is T.IDENT and self.peek().value.upper() == "NO":
            self.next()
            self.expect_kw("ACTION")
            return "NO ACTION"
        self.error("expected FK action")

    def _table_constraint(self) -> A.TableConstraint:
        name = None
        if self.accept_kw("CONSTRAINT"):
            name = self.ident()
        return self._table_constraint_body(name)

    def _table_constraint_body(self, name) -> A.TableConstraint:
        if self.accept_kw("PRIMARY"):
            self.expect_kw("KEY")
            cols = self._paren_idents()
            return A.TableConstraint("PRIMARY KEY", cols, name=name)
        if self.accept_kw("UNIQUE"):
            cols = self._paren_idents()
            return A.TableConstraint("UNIQUE", cols, name=name)
        if self.accept_kw("CHECK"):
            self.expect(T.LPAREN)
            e = self._expr()
            self.expect(T.RPAREN)
            return A.TableConstraint("CHECK", expr=e, name=name)
        if self.accept_kw("FOREIGN"):
            self.expect_kw("KEY")
            cols = self._paren_idents()
            self.expect_kw("REFERENCES")
            rt = self.ident()
            rcols = self._paren_idents() if self.peek().type is T.LPAREN else []
            od, ou = self._fk_actions()
            return A.TableConstraint(
                "FOREIGN KEY", cols, ref_table=rt, ref_columns=rcols,
                on_delete=od, on_update=ou, name=name,
            )
        self.error("expected table constraint")

    def _paren_idents(self) -> list:
        self.expect(T.LPAREN)
        out = [self.ident()]
        while self.accept(T.COMMA):
            out.append(self.ident())
        self.expect(T.RPAREN)
        return out

    def _drop(self) -> A.Drop:
        self.expect_kw("DROP")
        if self.accept_kw("TABLE"):
            kind = "TABLE"
        elif self.accept_kw("INDEX"):
            kind = "INDEX"
        elif self.accept_kw("SCHEMA"):
            kind = "SCHEMA"
        elif self.accept_kw("VIEW") or (
            self.accept_kw("MATERIALIZED") and self.expect_kw("VIEW") is None
        ):
            kind = "VIEW"
        elif self.peek().type is T.IDENT and self.peek().value.upper() == "TYPE":
            self.next()
            kind = "TYPE"
        elif self.peek().type is T.IDENT and \
                self.peek().value.upper() == "FUNCTION":
            self.next()
            kind = "FUNCTION"
        elif self.peek().type is T.IDENT and \
                self.peek().value.upper() == "TRIGGER":
            self.next()
            kind = "TRIGGER"
        elif self.peek().type is T.IDENT and \
                self.peek().value.upper() == "PROCEDURE":
            self.next()
            kind = "PROCEDURE"
        else:
            self.error(
                "expected TABLE/INDEX/SCHEMA/VIEW/TYPE/FUNCTION/"
                "PROCEDURE/TRIGGER"
            )
        if_exists = False
        if self.accept_kw("IF"):
            self.expect_kw("EXISTS")
            if_exists = True
        name = self.ident()
        schema = None
        if self.accept(T.DOT):
            schema, name = name, self.ident()
        self.accept_kw("CASCADE")
        return A.Drop(kind, name, schema, if_exists)

    def _alter(self) -> A.AlterTable:
        self.expect_kw("ALTER")
        self.expect_kw("TABLE")
        table = self._table_ref()
        if self.accept_kw("ADD"):
            if self.accept_kw("CONSTRAINT"):
                name = self.ident()
                tc = self._table_constraint_body(name)
                return A.AlterTable(table, "ADD_CONSTRAINT", constraint=tc)
            if self.peek().is_kw("PRIMARY", "UNIQUE", "CHECK", "FOREIGN"):
                tc = self._table_constraint_body(None)
                return A.AlterTable(table, "ADD_CONSTRAINT", constraint=tc)
            self.accept_kw("COLUMN")
            return A.AlterTable(table, "ADD_COLUMN", column=self._column_spec())
        if self.accept_kw("ALTER"):
            self.accept_kw("COLUMN")
            cname = self.ident()
            if self.accept_kw("SET"):
                if self.accept_kw("DEFAULT"):
                    return A.AlterTable(table, "ALTER_COLUMN", name=cname,
                                        col_action="SET_DEFAULT",
                                        expr=self._expr())
                if self.accept_kw("NOT"):
                    self.expect_kw("NULL")
                    return A.AlterTable(table, "ALTER_COLUMN", name=cname,
                                        col_action="SET_NOT_NULL")
                if self.peek().type is T.IDENT and \
                        self.peek().value.upper() == "DATA":
                    self.next()
                if self.peek().type is T.IDENT and \
                        self.peek().value.upper() == "TYPE":
                    self.next()
                tn, tp = self._type_name()
                return A.AlterTable(table, "ALTER_COLUMN", name=cname,
                                    col_action="SET_TYPE", type_name=tn,
                                    type_params=tp)
            if self.accept_kw("DROP"):
                if self.accept_kw("DEFAULT"):
                    return A.AlterTable(table, "ALTER_COLUMN", name=cname,
                                        col_action="DROP_DEFAULT")
                self.expect_kw("NOT")
                self.expect_kw("NULL")
                return A.AlterTable(table, "ALTER_COLUMN", name=cname,
                                    col_action="DROP_NOT_NULL")
            # bare TYPE form: ALTER COLUMN c TYPE T
            if self.peek().type is T.IDENT and \
                    self.peek().value.upper() == "TYPE":
                self.next()
                tn, tp = self._type_name()
                return A.AlterTable(table, "ALTER_COLUMN", name=cname,
                                    col_action="SET_TYPE", type_name=tn,
                                    type_params=tp)
            self.error("expected SET/DROP/TYPE after ALTER COLUMN")
        if self.accept_kw("DROP"):
            if self.accept_kw("CONSTRAINT"):
                if_exists = False
                if self.accept_kw("IF"):
                    self.expect_kw("EXISTS")
                    if_exists = True
                nm = self.ident()
                self.accept_kw("CASCADE")
                a = A.AlterTable(table, "DROP_CONSTRAINT", name=nm)
                a.col_action = "IF_EXISTS" if if_exists else None
                return a
            self.accept_kw("COLUMN")
            a = A.AlterTable(table, "DROP_COLUMN", name=self.ident())
            self.accept_kw("CASCADE") or self.accept_kw("RESTRICT")
            return a
        if self.accept_kw("RENAME"):
            if self.accept_kw("TO"):
                return A.AlterTable(table, "RENAME_TABLE", new_name=self.ident())
            self.expect_kw("COLUMN")
            old = self.ident()
            self.expect_kw("TO")
            return A.AlterTable(
                table, "RENAME_COLUMN", name=old, new_name=self.ident()
            )
        self.error("expected ADD/DROP/RENAME")

    # -- expressions (Pratt) ----------------------------------------------

    def _expr(self, min_bp: int = 0) -> A.Expr:
        lhs = self._prefix()
        while True:
            t = self.peek()
            # postfix/special operators
            if t.is_kw("IS"):
                if _BP["="] < min_bp:
                    break
                self.next()
                neg = self.accept_kw("NOT")
                if self.accept_kw("NULL"):
                    lhs = A.IsNull(lhs, neg)
                elif self.accept_kw("TRUE"):
                    cmp = A.BinaryOp("=", lhs, A.Literal(True))
                    lhs = A.UnaryOp("NOT", cmp) if neg else cmp
                elif self.accept_kw("FALSE"):
                    cmp = A.BinaryOp("=", lhs, A.Literal(False))
                    lhs = A.UnaryOp("NOT", cmp) if neg else cmp
                elif self.accept_kw("DISTINCT"):
                    # IS [NOT] DISTINCT FROM: null-safe comparison
                    self.expect_kw("FROM")
                    rhs = self._expr(_BP["="] + 1)
                    lhs = A.IsDistinct(lhs, rhs, negated=neg)
                else:
                    self.error("expected NULL/TRUE/FALSE/DISTINCT after IS")
                continue
            negated = False
            if t.is_kw("NOT") and (
                self.peek(1).is_kw("LIKE", "ILIKE", "IN", "BETWEEN")
                or (self.peek(1).type is T.IDENT
                    and self.peek(1).value.upper() == "SIMILAR")
            ):
                if _BP["="] < min_bp:
                    break
                self.next()
                negated = True
                t = self.peek()
            if t.type is T.IDENT and t.value.upper() == "SIMILAR" and \
                    self.peek(1).is_kw("TO"):
                if _BP["="] < min_bp:
                    break
                self.next()
                self.next()                      # TO
                pat = self._expr(_BP["="] + 1)
                esc = None
                if self.accept_kw("ESCAPE"):
                    esc = self._expr(_BP["="] + 1)
                lhs = A.Like(lhs, pat, negated, False, esc, similar=True)
                continue
            if t.is_kw("LIKE", "ILIKE"):
                if _BP["="] < min_bp:
                    break
                ci = t.value == "ILIKE"
                self.next()
                pat = self._expr(_BP["="] + 1)
                esc = None
                if self.accept_kw("ESCAPE"):
                    esc = self._expr(_BP["="] + 1)
                lhs = A.Like(lhs, pat, negated, ci, esc)
                continue
            if t.is_kw("IN"):
                if _BP["="] < min_bp:
                    break
                self.next()
                self.expect(T.LPAREN)
                if self.peek().is_kw("SELECT", "WITH"):
                    sub = self._select_stmt()
                    self.expect(T.RPAREN)
                    lhs = A.InSubquery(lhs, sub, negated)
                else:
                    items = [self._expr()]
                    while self.accept(T.COMMA):
                        items.append(self._expr())
                    self.expect(T.RPAREN)
                    lhs = A.InList(lhs, items, negated)
                continue
            if t.is_kw("BETWEEN"):
                if _BP["="] < min_bp:
                    break
                self.next()
                lo = self._expr(_BP["AND"] + 1)
                self.expect_kw("AND")
                hi = self._expr(_BP["AND"] + 1)
                lhs = A.Between(lhs, lo, hi, negated)
                continue
            if t.type is T.OP and t.value == "::":
                self.next()
                tn, tp = self._type_name()
                lhs = A.Cast(lhs, tn, tp)
                continue
            if t.type is T.LBRACKET:
                self.next()
                idx = self._expr()
                self.expect(T.RBRACKET)
                lhs = A.ArrayIndex(lhs, idx)
                continue

            op = None
            if t.type is T.OP and t.value in _BP:
                op = t.value
            elif t.is_kw("AND", "OR"):
                op = t.value
            if op is None:
                break
            bp = _BP[op]
            if bp < min_bp:
                break
            self.next()
            if (
                op in ("=", "!=", "<>", "<", "<=", ">", ">=")
                and self.peek().is_kw("ANY", "SOME", "ALL")
                and self.peek(1).type is T.LPAREN
            ):
                kind = "ALL" if self.peek().is_kw("ALL") else "ANY"
                self.next()
                self.expect(T.LPAREN)
                sub = self._select_stmt()
                self.expect(T.RPAREN)
                lhs = A.Quantified(op, lhs, kind, sub)
                continue
            rhs = self._expr(bp + 1)
            lhs = A.BinaryOp(op, lhs, rhs)
        return lhs

    def _prefix(self) -> A.Expr:
        t = self.next()
        if t.type is T.NUMBER:
            return A.Literal(_num(t.value))
        if t.type is T.STRING:
            return A.Literal(t.value)
        if t.type is T.BLOB:
            return A.Literal(bytes.fromhex(t.value))
        if t.type is T.PARAM:
            if t.value == "?":
                self._param_counter += 1
                return A.Param(self._param_counter)
            return A.Param(int(t.value[1:]))
        if t.is_kw("NULL"):
            return A.Literal(None)
        if t.is_kw("TRUE"):
            return A.Literal(True)
        if t.is_kw("FALSE"):
            return A.Literal(False)
        if t.is_kw("NOT"):
            return A.UnaryOp("NOT", self._expr(_BP["AND"] + 1))
        if t.type is T.OP and t.value in ("-", "+"):
            operand = self._expr(_BP["*"] + 10)
            if t.value == "-" and isinstance(operand, A.Literal) and isinstance(
                operand.value, (int, float)
            ):
                return A.Literal(-operand.value)
            return A.UnaryOp(t.value, operand)
        if t.is_kw("CASE"):
            return self._case()
        if t.is_kw("CAST"):
            self.expect(T.LPAREN)
            e = self._expr()
            self.expect_kw("AS")
            tn, tp = self._type_name()
            self.expect(T.RPAREN)
            return A.Cast(e, tn, tp)
        if t.is_kw("EXISTS"):
            self.expect(T.LPAREN)
            sub = self._select_stmt()
            self.expect(T.RPAREN)
            return A.Exists(sub)
        if t.is_kw("ARRAY"):
            self.expect(T.LBRACKET)
            items = []
            if self.peek().type is not T.RBRACKET:
                items = [self._expr()]
                while self.accept(T.COMMA):
                    items.append(self._expr())
            self.expect(T.RBRACKET)
            return A.ArrayLiteral(items)
        if t.is_kw("INTERVAL", "DATE", "TIME", "TIMESTAMP", "VECTOR") and \
                self.peek().type is T.STRING:
            return A.TypedLiteral(t.value, self.next().value)
        if t.type is T.LPAREN:
            if self.peek().is_kw("SELECT", "WITH"):
                sub = self._select_stmt()
                self.expect(T.RPAREN)
                return A.ScalarSubquery(sub)
            e = self._expr()
            self.expect(T.RPAREN)
            return e
        if t.is_kw("IF", "LEFT", "RIGHT", "INSERT") and \
                self.peek().type is T.LPAREN:
            # keyword-named scalar functions: IF(c,a,b), LEFT/RIGHT(s,n),
            # INSERT(s,pos,len,new) — unambiguous because no keyword use
            # of these precedes '(' in expression position
            return self._func_call(t.value.lower())
        if t.type is T.IDENT and t.value.upper() in _NILADIC and \
                self.peek().type is not T.LPAREN:
            # SQL-standard niladic forms: CURRENT_DATE, CURRENT_USER, ...
            return A.FuncCall(t.value.lower())
        if t.type is T.IDENT or (t.type is T.KEYWORD and t.value in _SOFT_IDENT):
            name = t.value.lower() if t.type is T.KEYWORD else t.value
            # function call
            if self.peek().type is T.LPAREN:
                return self._func_call(name)
            # qualified column
            if self.peek().type is T.DOT:
                self.next()
                nxt = self.peek()
                if nxt.type is T.OP and nxt.value == "*":
                    self.next()
                    return A.Star(table=name)
                col = self.ident()
                return A.ColumnRef(col, table=name)
            return A.ColumnRef(name)
        self.pos -= 1
        self.error("unexpected token in expression")

    def _case(self) -> A.Case:
        case = A.Case()
        if not self.peek().is_kw("WHEN"):
            case.operand = self._expr()
        whens = []
        while self.accept_kw("WHEN"):
            cond = self._expr()
            self.expect_kw("THEN")
            whens.append((cond, self._expr()))
        case.whens = whens
        if self.accept_kw("ELSE"):
            case.else_ = self._expr()
        self.expect_kw("END")
        return case

    def _func_call(self, name: str) -> A.Expr:
        self.expect(T.LPAREN)
        fc = A.FuncCall(name.lower())
        if self.peek().type is T.OP and self.peek().value == "*":
            self.next()
            fc.star = True
        elif self.peek().type is not T.RPAREN:
            if self.accept_kw("DISTINCT"):
                fc.distinct = True
            if fc.name == "trim" and (
                self.peek().type is T.IDENT
                and self.peek().value.upper() in ("LEADING", "TRAILING",
                                                  "BOTH")
            ):
                # SQL-standard TRIM([LEADING|TRAILING|BOTH] [ch] FROM s)
                mode = self.next().value.upper()
                chars = None
                if not self.peek().is_kw("FROM"):
                    chars = self._expr()
                self.expect_kw("FROM")
                s = self._expr()
                name2 = {"LEADING": "ltrim", "TRAILING": "rtrim",
                         "BOTH": "trim"}[mode]
                fc = A.FuncCall(name2, [s] + ([chars] if chars else []))
            elif fc.name == "trim":
                first = self._expr()
                if self.accept_kw("FROM"):   # modeless TRIM(ch FROM s)
                    fc.args = [self._expr(), first]
                else:
                    fc.args = [first]
            elif fc.name == "position":
                # POSITION(substr IN str) = LOCATE(substr, str): parse the
                # first operand ABOVE comparison bp so IN stays a keyword
                first = self._expr(_BP["="] + 1)
                if self.accept_kw("IN"):
                    fc = A.FuncCall("locate", [first, self._expr()])
                else:
                    fc.args = [first]
            else:
                fc.args = [self._expr()]
            while self.accept(T.COMMA):
                fc.args.append(self._expr())
        if self.peek().is_kw("ORDER"):
            # aggregate ORDER BY: string_agg(x, ',' ORDER BY y) — only
            # order-sensitive aggregates honor it (engine enforces)
            fc.order_by = self._order_by()
        self.expect(T.RPAREN)
        if (self.peek().type is T.IDENT
                and self.peek().value.upper() == "WITHIN"):
            # ordered-set aggregate: fn(..) WITHIN GROUP (ORDER BY x)
            self.next()
            self.expect_kw("GROUP")
            self.expect(T.LPAREN)
            fc.order_by = self._order_by()
            self.expect(T.RPAREN)
            fc.within_group = True
        if self.accept_kw("FILTER"):
            self.expect(T.LPAREN)
            self.expect_kw("WHERE")
            fc.filter = self._expr()
            self.expect(T.RPAREN)
        if self.accept_kw("OVER"):
            if self.peek().type is T.IDENT:
                # OVER w — named window; the WINDOW clause that defines
                # it parses later in the SELECT, so leave the name for
                # _select_core to resolve
                fc.over = self.ident().lower()
                self._over_names = True
                return fc
            self.expect(T.LPAREN)
            fc.over = self._window_spec_body()
            self.expect(T.RPAREN)
        return fc

    def _window_spec_body(self) -> A.WindowSpec:
        """The inside of OVER (...) / WINDOW w AS (...)."""
        spec = A.WindowSpec()
        if self.accept_kw("PARTITION"):
            self.expect_kw("BY")
            spec.partition_by = [self._expr()]
            while self.accept(T.COMMA):
                spec.partition_by.append(self._expr())
        if self.peek().is_kw("ORDER"):
            spec.order_by = self._order_by()
        if self.peek().type is T.IDENT and \
                self.peek().value.upper() in ("ROWS", "RANGE", "GROUPS"):
            mode = self.next().value.upper()

            def _bound():
                tk = self.peek()
                if tk.type is T.IDENT and tk.value.upper() == "UNBOUNDED":
                    self.next()
                    w = self.ident().upper()
                    if w not in ("PRECEDING", "FOLLOWING"):
                        self.error("expected PRECEDING/FOLLOWING")
                    return "up" if w == "PRECEDING" else "uf"
                if tk.type is T.IDENT and tk.value.upper() == "CURRENT":
                    self.next()
                    if self.ident().upper() != "ROW":
                        self.error("expected ROW after CURRENT")
                    return 0
                # ROWS/GROUPS bounds count rows/peer-groups and must
                # be integers (SQLite raises on fractions); RANGE
                # bounds are order-key distances and may be fractional
                k = _num(self.expect(T.NUMBER).value)
                if mode in ("ROWS", "GROUPS"):
                    if isinstance(k, float) and not k.is_integer():
                        self.error(
                            f"{mode} frame offset must be an integer"
                        )
                    k = int(k)
                w = self.ident().upper()
                if w not in ("PRECEDING", "FOLLOWING"):
                    self.error("expected PRECEDING/FOLLOWING")
                return -k if w == "PRECEDING" else k

            if self.accept_kw("BETWEEN"):
                lo = _bound()
                self.expect_kw("AND")
                hi = _bound()
            else:
                lo, hi = _bound(), 0
            exclude = None
            if (self.peek().type is T.IDENT
                    and self.peek().value.upper() == "EXCLUDE"):
                self.next()
                w = self.next().value.upper()
                if w == "NO":
                    if self.ident().upper() != "OTHERS":
                        self.error("expected OTHERS after EXCLUDE NO")
                elif w == "CURRENT":
                    if self.ident().upper() != "ROW":
                        self.error("expected ROW after EXCLUDE CURRENT")
                    exclude = "CURRENT"
                elif w in ("GROUP", "TIES"):
                    exclude = w
                else:
                    self.error(
                        "expected NO OTHERS / CURRENT ROW / GROUP / "
                        "TIES after EXCLUDE"
                    )
            spec.frame = (mode, lo, hi, exclude)
        return spec


def _resolve_named_windows(sel, windows):
    """Replace string `OVER w` references in this SELECT's own clauses
    with the WINDOW-clause specs (nested Selects resolved their own)."""
    import dataclasses

    def walk(node):
        if isinstance(node, A.Select):
            return                      # inner scope: already resolved
        if isinstance(node, A.FuncCall) and isinstance(node.over, str):
            spec = (windows or {}).get(node.over)
            if spec is None:
                raise SqlError(f"no such window: {node.over}")
            node.over = spec
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            for f in dataclasses.fields(node):
                walk(getattr(node, f.name))
        elif isinstance(node, (list, tuple)):
            for x in node:
                walk(x)

    for part in (sel.items, sel.order_by, sel.having):
        walk(part)


# keywords that may double as identifiers/function names
# SQL-standard niladic functions: bare identifiers that evaluate as calls
_NILADIC = {
    "CURRENT_DATE", "CURRENT_TIME", "CURRENT_TIMESTAMP", "CURRENT_USER",
    "SESSION_USER", "SYSTEM_USER", "LOCALTIME", "LOCALTIMESTAMP",
}

_SOFT_IDENT = {
    "DATE", "TIME", "TIMESTAMP", "INTERVAL", "VECTOR", "FIRST", "LAST",
    "KEY", "ACTION", "SCHEMA", "WORK", "FILTER", "ANY", "SOME", "DO",
}

# DELETE/UPDATE appear inside ON DELETE / ON UPDATE fk actions
_SOFT_IDENT |= {"DELETE", "UPDATE"}
# statement keywords that also name scalar functions (TRUNCATE(n, d))
_SOFT_IDENT |= {"TRUNCATE"}
# view/config keywords stay usable as identifiers
_SOFT_IDENT |= {"VIEW", "REPLACE", "MATERIALIZED", "SHOW", "SESSION", "LOCAL"}


def _num(text: str):
    if text.lower().startswith("0x"):
        return int(text, 16)
    if "." in text or "e" in text.lower():
        return float(text)
    return int(text)


def parse_sql(sql: str):
    """Parse a single statement."""
    return Parser(sql).parse_statement()


def parse_script(sql: str) -> list:
    return Parser(sql).parse_script()


def split_statements(sql: str) -> list[str]:
    """Split a script into per-statement SOURCE TEXT (trigger bodies and
    string literals keep their inner semicolons): parse each statement
    and slice the source by token offsets."""
    p = Parser(sql)
    out = []
    while p.peek().type is not T.EOF:
        start = p.peek().off
        p._statement()
        end = p.peek().off if p.peek().type is not T.EOF else len(sql)
        out.append(sql[start:end].strip().rstrip(";"))
        while p.accept(T.SEMI):
            pass
    return [s for s in out if s]
