"""REPL: multi-line SQL until ';', dot-commands, ASCII table output.

Counterpart of reference src/cli/repl.rs:87 (rustyline REPL), commands.rs
(.tables/.schema/.indexes), table.rs:63 (ASCII formatter), with readline
history at ~/.turdb_tpu_history.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def render_create_table(info) -> str:
    """Reconstruct the CREATE TABLE statement from the catalog
    (reference .schema shows CREATE statements, cli/commands.rs)."""
    from turdb_tpu_torch.types.datatype import DataType

    lines = []
    for c in info.columns:
        ty = c.dtype.name
        if c.dtype in (DataType.VARCHAR, DataType.CHAR) and c.max_len:
            ty = f"{ty}({c.max_len})"
        elif c.dtype is DataType.VECTOR and c.vector_dim:
            ty = f"VECTOR({c.vector_dim})"
        elif c.dtype is DataType.DECIMAL and c.precision:
            ty = (f"DECIMAL({c.precision}, {c.scale})"
                  if c.scale is not None else f"DECIMAL({c.precision})")
        elif c.type_name:
            ty = c.type_name
        bits = [c.name, ty]
        if c.primary_key:
            bits.append("PRIMARY KEY")
        if c.auto_increment:
            bits.append("AUTO_INCREMENT")
        if not c.nullable and not c.primary_key:
            bits.append("NOT NULL")
        if c.unique and not c.primary_key:
            bits.append("UNIQUE")
        if c.has_default:
            from turdb_tpu_torch.sql.ast import Expr, render_expr

            d = c.default
            if isinstance(d, Expr):
                d = render_expr(d)
            elif isinstance(d, str) and not d[:1].isdigit():
                d = d if d.upper().startswith(("CURRENT", "NOW")) else d
            bits.append(f"DEFAULT {d}")
        if c.check is not None:
            from turdb_tpu_torch.sql.ast import Expr, render_expr

            ce = c.check
            bits.append(f"CHECK ({render_expr(ce) if isinstance(ce, Expr) else ce})")
        if c.references is not None:
            rt, rc, od, ou = c.references
            r = f"REFERENCES {rt}" + (f"({rc})" if rc else "")
            if od:
                r += f" ON DELETE {od}"
            if ou:
                r += f" ON UPDATE {ou}"
            bits.append(r)
        lines.append("    " + " ".join(bits))
    for nm, chk in zip(info.check_names, info.checks):
        from turdb_tpu_torch.sql.ast import Expr, render_expr

        body = render_expr(chk) if isinstance(chk, Expr) else str(chk)
        pre = f"CONSTRAINT {nm} " if nm else ""
        lines.append(f"    {pre}CHECK ({body})")
    for (cols, rt, rcols, od, ou), nm in zip(info.fks, info.fk_names):
        pre = f"CONSTRAINT {nm} " if nm else ""
        fk = (f"    {pre}FOREIGN KEY ({', '.join(cols)}) REFERENCES {rt}"
              + (f" ({', '.join(rcols)})" if rcols else ""))
        if od:
            fk += f" ON DELETE {od}"
        if ou:
            fk += f" ON UPDATE {ou}"
        # column-level REFERENCES already rendered inline above
        if not (len(cols) == 1 and any(
                c.name == cols[0] and c.references for c in info.columns)):
            lines.append(fk)
    out = f"CREATE TABLE {info.table.name} (\n" + ",\n".join(lines) + "\n);"
    for idef in info.index_defs.values():
        if idef.name.startswith("__"):
            continue   # auto-created PK/unique indexes render inline
        from turdb_tpu_torch.sql.ast import render_expr as _re

        cols = ", ".join(
            _re(e) + (" DESC" if desc else "") for e, desc in idef.columns
        )
        uq = "UNIQUE " if idef.unique else ""
        using = f" USING {idef.using}" if idef.using != "BTREE" else ""
        out += (f"\nCREATE {uq}INDEX {idef.name} ON "
                f"{info.table.name}{using} ({cols});")
    return out


def format_table(columns: list[str], rows: list[tuple]) -> str:
    """ASCII table (reference cli/table.rs:63)."""
    if not columns:
        return ""

    def cell(v) -> str:
        if v is None:
            return "NULL"
        if isinstance(v, float):
            return f"{v:.6g}"
        if isinstance(v, (list, tuple)):
            return "[" + ", ".join(cell(x) for x in v) + "]"
        try:
            import numpy as np

            if isinstance(v, np.ndarray):
                inner = ", ".join(f"{x:.4g}" for x in v[:6])
                if len(v) > 6:
                    inner += ", …"
                return "[" + inner + "]"
        except ImportError:
            pass
        return str(v)

    grid = [[cell(v) for v in row] for row in rows]
    widths = [len(c) for c in columns]
    for row in grid:
        for j, c in enumerate(row):
            widths[j] = max(widths[j], len(c))
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    out = [sep]
    out.append(
        "|" + "|".join(f" {c.ljust(w)} " for c, w in zip(columns, widths)) + "|"
    )
    out.append(sep)
    for row in grid:
        out.append(
            "|" + "|".join(f" {c.ljust(w)} " for c, w in zip(row, widths)) + "|"
        )
    out.append(sep)
    return "\n".join(out)


class Repl:
    def __init__(self, db, out=None):
        self.db = db
        self.out = out  # None = current sys.stdout at write time
        self.buffer: list[str] = []

    def write(self, text=""):
        print(text, file=self.out or sys.stdout)

    # -- dot commands (reference cli/commands.rs) -------------------------

    def dot_command(self, line: str) -> bool:
        parts = line.split()
        cmd = parts[0]
        if cmd in (".quit", ".exit", ".q"):
            return False
        if cmd in (".help", ".h", ".?"):    # reference commands.rs:62
            self.write(
                ".tables [schema]   list tables\n"
                ".schema <table>    show CREATE-ish schema\n"
                ".indexes [table]   list indexes\n"
                ".timer on|off      toggle query timing\n"
                ".quit              exit"
            )
        elif cmd == ".tables":
            rows = self.db.query(
                "SELECT schema, name FROM turdb_catalog.tables ORDER BY schema, name"
            )
            for s, n in rows:
                self.write(f"{s}.{n}")
        elif cmd == ".schema":
            if len(parts) < 2:
                self.write("usage: .schema <table>")
            else:
                info = None
                for schema, tables in self.db.catalog.items():
                    if parts[1] in tables:
                        info = tables[parts[1]]
                        break
                if info is None:
                    self.write(f"no such table: {parts[1]}")
                else:
                    self.write(render_create_table(info))
        elif cmd == ".indexes":
            sql = (
                "SELECT \"table\", name, using, is_unique, entries FROM "
                "turdb_catalog.indexes"
            )
            if len(parts) > 1:
                sql += f" WHERE \"table\" = '{parts[1]}'"
            cols, rows = self.db.query_with_columns(sql)
            self.write(format_table(cols, rows))
        elif cmd == ".timer":
            self.timer = len(parts) > 1 and parts[1] == "on"
        else:
            self.write(f"unknown command {cmd}; try .help")
        return True

    timer = False

    def feed(self, line: str) -> bool:
        """Process one input line; returns False to exit."""
        stripped = line.strip()
        if not self.buffer and stripped.startswith("."):
            return self.dot_command(stripped)
        self.buffer.append(line)
        if not stripped.endswith(";"):
            return True
        whole = "\n".join(self.buffer).strip()
        up = " ".join(whole.upper().split())
        if (up.startswith(("CREATE TRIGGER", "CREATE OR REPLACE TRIGGER"))
                and " BEGIN " in f" {up} "
                and not up.rstrip(";").rstrip().endswith("END")):
            return True   # inside a trigger body: ';' ends inner stmts
        sql = whole.rstrip(";")
        self.buffer = []
        if not sql:
            return True
        t0 = time.perf_counter()
        try:
            cols, rows = self.db.query_with_columns(sql)
            if cols:
                self.write(format_table(cols, rows))
                self.write(f"({len(rows)} row{'s' if len(rows) != 1 else ''})")
            else:
                res_txt = "ok"
                self.write(res_txt)
            if self.timer:
                self.write(f"time: {(time.perf_counter() - t0) * 1e3:.1f} ms")
        except Exception as e:  # surface, don't crash the REPL
            self.write(f"error: {e}")
        return True

    def prompt(self) -> str:
        return "  ...> " if self.buffer else "turdb> "

    def run_interactive(self):
        try:
            import readline

            hist = os.path.expanduser("~/.turdb_tpu_history")
            try:
                readline.read_history_file(hist)
            except (FileNotFoundError, OSError):
                pass
        except ImportError:
            readline = None
        self.write("turdb-tpu — TPU-native data engine. Type .help for help.")
        while True:
            try:
                line = input(self.prompt())
            except EOFError:
                break
            except KeyboardInterrupt:
                self.buffer = []
                self.write()
                continue
            if not self.feed(line):
                break
        if readline is not None:
            try:
                readline.write_history_file(hist)
            except OSError:
                pass


def main(argv=None):
    ap = argparse.ArgumentParser(prog="turdb-tpu", description="turdb-tpu CLI")
    ap.add_argument("database", nargs="?", help="database directory "
                    "(created if missing)")
    ap.add_argument("-c", "--command", help="execute one SQL statement and exit")
    ap.add_argument("--create", action="store_true",
                    help="create a new database (error if it exists)")
    ap.add_argument("--version", action="store_true", help="show version")
    ap.add_argument("--device", default="cuda",
                    help="device of the vector indexes (default cuda; cpu where "
                    "there is no GPU)")
    args = ap.parse_args(argv)

    if args.version:
        from turdb_tpu_torch import __version__

        print(f"turdb-tpu {__version__}")
        return 0
    if not args.database:
        ap.error("the following arguments are required: database")

    from turdb_tpu_torch.database.api import Database, connect

    if args.create:
        if os.path.exists(args.database):
            print(f"error: {args.database} already exists", file=sys.stderr)
            return 1
        db = Database.create(args.database, device=args.device)
    else:
        db = connect(args.database, device=args.device)
    try:
        if args.command:
            from turdb_tpu_torch.sql.parser import split_statements

            repl = Repl(db)
            for stmt in split_statements(args.command):
                repl.feed(stmt + ";")
            return 0
        Repl(db).run_interactive()
        return 0
    finally:
        db.close()


if __name__ == "__main__":
    raise SystemExit(main())
