"""SQL parser — analogue of eKuiper's internal/xsql/parser.go (Parser.Parse
at parser.go:150, ParseCreateStmt at :1158, window validation at :1047-1119).

Recursive-descent with precedence climbing (precedence table mirrors
pkg/ast/token.go:303-318). Windows are parsed as table functions inside
GROUP BY — TUMBLINGWINDOW(ss, 10) etc. — and converted to ast.Window with the
same arity rules as the reference's validateWindows/ConvertToWindows.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..data.types import DataType
from ..utils.infra import ParseError
from . import ast
from .lexer import (
    EOF, IDENT, INTEGER, KEYWORD, NUMBER, OP, STRING, TIME_UNITS, Token,
    TokenStream,
)

WINDOW_FUNCS = {
    "tumblingwindow": ast.WindowType.TUMBLING_WINDOW,
    "hoppingwindow": ast.WindowType.HOPPING_WINDOW,
    "slidingwindow": ast.WindowType.SLIDING_WINDOW,
    "sessionwindow": ast.WindowType.SESSION_WINDOW,
    "countwindow": ast.WindowType.COUNT_WINDOW,
    "statewindow": ast.WindowType.STATE_WINDOW,
}

_TYPE_NAMES = {
    "BIGINT": DataType.BIGINT,
    "FLOAT": DataType.FLOAT,
    "STRING": DataType.STRING,
    "BYTEA": DataType.BYTEA,
    "DATETIME": DataType.DATETIME,
    "BOOLEAN": DataType.BOOLEAN,
    "ARRAY": DataType.ARRAY,
    "STRUCT": DataType.STRUCT,
}


class Parser:
    def __init__(self, sql: str) -> None:
        self.ts = TokenStream(sql)
        self._func_id = 0

    # ------------------------------------------------------------- entry points
    def parse(self) -> ast.Statement:
        tok = self.ts.peek()
        if tok.kind == KEYWORD:
            if tok.text == "SELECT":
                stmt = self.parse_select()
            elif tok.text == "CREATE":
                stmt = self.parse_create()
            elif tok.text == "SHOW":
                stmt = self.parse_show()
            elif tok.text in ("DESCRIBE", "DESC"):
                stmt = self.parse_describe()
            elif tok.text == "DROP":
                stmt = self.parse_drop()
            elif tok.text == "EXPLAIN":
                stmt = self.parse_explain()
            else:
                raise ParseError(f"unexpected keyword {tok.text} at start of statement")
        else:
            raise ParseError(f"expected statement but found {tok.text!r}")
        self.ts.accept(OP, ";")
        if self.ts.peek().kind != EOF:
            extra = self.ts.peek()
            raise ParseError(f"unexpected trailing input {extra.text!r} at {extra.pos}")
        return stmt

    # ----------------------------------------------------------------- SELECT
    def parse_select(self) -> ast.SelectStatement:
        self.ts.expect(KEYWORD, "SELECT")
        stmt = ast.SelectStatement()
        stmt.fields = self.parse_fields()
        if self.ts.accept(KEYWORD, "FROM"):
            stmt.sources.append(self.parse_table())
            while True:
                join = self.parse_join()
                if join is None:
                    break
                stmt.joins.append(join)
        else:
            raise ParseError("SELECT requires a FROM clause")
        if self.ts.accept(KEYWORD, "WHERE"):
            stmt.condition = self.parse_expr()
        if self.ts.accept(KEYWORD, "GROUP"):
            self.ts.expect(KEYWORD, "BY")
            self._parse_dimensions(stmt)
        if self.ts.accept(KEYWORD, "HAVING"):
            stmt.having = self.parse_expr()
        if self.ts.accept(KEYWORD, "ORDER"):
            self.ts.expect(KEYWORD, "BY")
            stmt.sorts = self.parse_sort_fields()
        if self.ts.accept(KEYWORD, "LIMIT"):
            lim = self.ts.expect(INTEGER)
            stmt.limit = int(lim.text)
        return stmt

    def parse_fields(self) -> List[ast.Field]:
        fields: List[ast.Field] = []
        while True:
            fields.append(self.parse_field(len(fields)))
            if not self.ts.accept(OP, ","):
                break
        return fields

    def parse_field(self, idx: int) -> ast.Field:
        expr = self.parse_expr()
        alias = ""
        if self.ts.accept(KEYWORD, "AS"):
            alias = self._ident_like()
        invisible = bool(self.ts.accept(KEYWORD, "INVISIBLE"))
        name = self._derive_name(expr, idx)
        return ast.Field(expr=expr, name=name, alias=alias, invisible=invisible)

    @staticmethod
    def _derive_name(expr: ast.Expr, idx: int) -> str:
        if isinstance(expr, ast.FieldRef):
            return expr.name
        if isinstance(expr, ast.Call):
            return expr.name
        if isinstance(expr, ast.Wildcard):
            return "*"
        if isinstance(expr, ast.ArrowExpr):
            return expr.name
        return f"kuiper_field_{idx}"

    def _ident_like(self) -> str:
        tok = self.ts.peek()
        if tok.kind == IDENT:
            return self.ts.next().text
        if tok.kind == KEYWORD:  # allow keywords as aliases (e.g. AS end)
            return self.ts.next().text.lower()
        raise ParseError(f"expected identifier but found {tok.text!r} at {tok.pos}")

    def parse_table(self) -> ast.Table:
        name = self._ident_like()
        alias = ""
        if self.ts.accept(KEYWORD, "AS"):
            alias = self._ident_like()
        elif self.ts.peek().kind == IDENT and not self.ts.at_keyword():
            # bare alias: FROM demo d
            alias = self.ts.next().text
        return ast.Table(name=name, alias=alias)

    def parse_join(self) -> Optional[ast.Join]:
        jt: Optional[ast.JoinType] = None
        if self.ts.accept(KEYWORD, "JOIN"):
            jt = ast.JoinType.INNER
        elif self.ts.at_keyword("INNER", "LEFT", "RIGHT", "FULL", "CROSS"):
            kw = self.ts.next().text
            self.ts.expect(KEYWORD, "JOIN")
            jt = ast.JoinType[kw]
        else:
            return None
        table = self.parse_table()
        on: Optional[ast.Expr] = None
        if self.ts.accept(KEYWORD, "ON"):
            on = self.parse_expr()
        elif jt != ast.JoinType.CROSS:
            raise ParseError(f"{jt.value} JOIN requires an ON clause")
        return ast.Join(table=table, join_type=jt, on=on)

    def _parse_dimensions(self, stmt: ast.SelectStatement) -> None:
        while True:
            expr = self.parse_expr()
            window = self._try_window(expr)
            if window is not None:
                if stmt.window is not None:
                    raise ParseError("at most one window per statement")
                stmt.window = window
            else:
                stmt.dimensions.append(ast.Dimension(expr=expr))
            if not self.ts.accept(OP, ","):
                break

    def _try_window(self, expr: ast.Expr) -> Optional[ast.Window]:
        if not isinstance(expr, ast.Call):
            return None
        wtype = WINDOW_FUNCS.get(expr.name.lower())
        if wtype is None:
            return None
        win = self._convert_window(wtype, expr.args)
        # FILTER(WHERE ...) attached to the window call
        if expr.filter is not None:
            win.filter = expr.filter
        if expr.when is not None:
            win.trigger_condition = expr.when
        return win

    def _convert_window(self, wtype: ast.WindowType, args: List[ast.Expr]) -> ast.Window:
        """Mirrors validateWindows + ConvertToWindows
        (reference: internal/xsql/parser.go:1047-1160)."""
        name = wtype.value
        win = ast.Window(window_type=wtype)
        if wtype == ast.WindowType.STATE_WINDOW:
            if len(args) != 2:
                raise ParseError(f"the arguments for {name} should be 2")
            win.begin_condition, win.emit_condition = args[0], args[1]
            return win
        if wtype == ast.WindowType.COUNT_WINDOW:
            if not args or len(args) > 2:
                raise ParseError(f"invalid parameter count for {name}")
            if not isinstance(args[0], ast.IntegerLiteral) or args[0].val <= 0:
                raise ParseError(f"invalid parameter value for {name}")
            win.length = args[0].val
            if len(args) == 2:
                if not isinstance(args[1], ast.IntegerLiteral) or args[1].val <= 0:
                    raise ParseError(f"invalid parameter value for {name}")
                if args[0].val < args[1].val:
                    raise ParseError(
                        f"the second parameter {args[1].val} should be <= the first {args[0].val}"
                    )
                win.interval = args[1].val
            return win
        expect = {
            ast.WindowType.TUMBLING_WINDOW: (2, 2),
            ast.WindowType.HOPPING_WINDOW: (3, 3),
            ast.WindowType.SESSION_WINDOW: (3, 3),
            ast.WindowType.SLIDING_WINDOW: (2, 3),
        }[wtype]
        if not (expect[0] <= len(args) <= expect[1]):
            raise ParseError(f"the arguments for {name} should be {expect[0]}")
        if not isinstance(args[0], ast.TimeLiteral):
            raise ParseError(
                f"the 1st argument for {name} must be a time unit [dd|hh|mi|ss|ms]"
            )
        for a in args[1:]:
            if not isinstance(a, ast.IntegerLiteral):
                raise ParseError(f"the arguments for {name} must be integer literals")
        win.time_unit = args[0].val
        win.length = args[1].val
        if len(args) > 2:
            if wtype == ast.WindowType.SLIDING_WINDOW:
                win.delay = args[2].val
            else:
                win.interval = args[2].val
        return win

    def parse_sort_fields(self) -> List[ast.SortField]:
        sorts: List[ast.SortField] = []
        while True:
            expr = self.parse_expr()
            sf = ast.SortField(name="", expr=expr)
            if isinstance(expr, ast.FieldRef):
                sf.name, sf.stream = expr.name, expr.stream
            if self.ts.accept(KEYWORD, "DESC"):
                sf.ascending = False
            else:
                self.ts.accept(KEYWORD, "ASC")
            sorts.append(sf)
            if not self.ts.accept(OP, ","):
                break
        return sorts

    # ------------------------------------------------------------ expressions
    def parse_expr(self, min_prec: int = 1) -> ast.Expr:
        lhs = self.parse_unary()
        while True:
            op, prec, negate = self._peek_binary_op()
            if op is None or prec < min_prec:
                return lhs
            self._consume_binary_op(op, negate)
            if op == "BETWEEN":
                lo = self.parse_expr(ast.PRECEDENCE["BETWEEN"] + 1)
                self.ts.expect(KEYWORD, "AND")
                hi = self.parse_expr(ast.PRECEDENCE["BETWEEN"] + 1)
                lhs = ast.BetweenExpr(value=lhs, lo=lo, hi=hi, negate=negate)
            elif op == "IN":
                self.ts.expect(OP, "(")
                values = [self.parse_expr()]
                while self.ts.accept(OP, ","):
                    values.append(self.parse_expr())
                self.ts.expect(OP, ")")
                lhs = ast.InExpr(value=lhs, values=values, negate=negate)
            elif op == "LIKE":
                pattern = self.parse_expr(ast.PRECEDENCE["LIKE"] + 1)
                lhs = ast.LikeExpr(value=lhs, pattern=pattern, negate=negate)
            else:
                rhs = self.parse_expr(prec + 1)
                lhs = ast.BinaryExpr(op=op, lhs=lhs, rhs=rhs)

    def _peek_binary_op(self) -> Tuple[Optional[str], int, bool]:
        tok = self.ts.peek()
        if tok.kind == OP and tok.text in ast.PRECEDENCE:
            return tok.text, ast.PRECEDENCE[tok.text], False
        if tok.kind == KEYWORD:
            if tok.text in ("AND", "OR", "IN", "BETWEEN", "LIKE"):
                return tok.text, ast.PRECEDENCE[tok.text], False
            if tok.text == "NOT":
                nxt = self.ts.peek(1)
                if nxt.kind == KEYWORD and nxt.text in ("IN", "BETWEEN", "LIKE"):
                    return nxt.text, ast.PRECEDENCE[nxt.text], True
        return None, 0, False

    def _consume_binary_op(self, op: str, negate: bool) -> None:
        if negate:
            self.ts.next()  # NOT
        self.ts.next()  # the operator itself

    def parse_unary(self) -> ast.Expr:
        if self.ts.accept(KEYWORD, "NOT"):
            return ast.UnaryExpr(op="NOT", expr=self.parse_unary())
        if self.ts.accept(OP, "-"):
            inner = self.parse_unary()
            if isinstance(inner, ast.IntegerLiteral):
                return ast.IntegerLiteral(-inner.val)
            if isinstance(inner, ast.NumberLiteral):
                return ast.NumberLiteral(-inner.val)
            return ast.UnaryExpr(op="-", expr=inner)
        self.ts.accept(OP, "+")
        return self.parse_postfix()

    def parse_postfix(self) -> ast.Expr:
        expr = self.parse_primary()
        while True:
            if self.ts.accept(OP, "["):
                expr = self._parse_index(expr)
            elif self.ts.accept(OP, "->"):
                name = self._ident_like()
                expr = ast.ArrowExpr(value=expr, name=name)
            elif (
                self.ts.peek().kind == OP
                and self.ts.peek().text == "."
                and not isinstance(expr, (ast.FieldRef, ast.Wildcard))
            ):
                # json path continuation on non-ref values: f(x).y
                self.ts.next()
                expr = ast.ArrowExpr(value=expr, name=self._ident_like())
            else:
                return expr

    def _parse_index(self, value: ast.Expr) -> ast.Expr:
        # a[i], a[i:j], a[:j], a[i:], a[:]
        lo = hi = index = None
        is_slice = False
        if self.ts.accept(OP, ":"):
            is_slice = True
            if not (self.ts.peek().kind == OP and self.ts.peek().text == "]"):
                hi = self.parse_expr()
        else:
            index = self.parse_expr()
            if self.ts.accept(OP, ":"):
                is_slice = True
                lo, index = index, None
                if not (self.ts.peek().kind == OP and self.ts.peek().text == "]"):
                    hi = self.parse_expr()
        self.ts.expect(OP, "]")
        return ast.IndexExpr(value=value, index=index, lo=lo, hi=hi, is_slice=is_slice)

    def parse_primary(self) -> ast.Expr:
        tok = self.ts.peek()
        if tok.kind == INTEGER:
            self.ts.next()
            return ast.IntegerLiteral(int(tok.text))
        if tok.kind == NUMBER:
            self.ts.next()
            return ast.NumberLiteral(float(tok.text))
        if tok.kind == STRING:
            self.ts.next()
            return ast.StringLiteral(tok.text)
        if tok.kind == KEYWORD and tok.text in ("TRUE", "FALSE"):
            self.ts.next()
            return ast.BooleanLiteral(tok.text == "TRUE")
        if tok.kind == KEYWORD and tok.text == "CASE":
            return self.parse_case()
        if tok.kind == OP and tok.text == "*":
            self.ts.next()
            return self._parse_wildcard()
        if tok.kind == OP and tok.text == "(":
            self.ts.next()
            expr = self.parse_expr()
            self.ts.expect(OP, ")")
            return expr
        if tok.kind == IDENT or (
            tok.kind == KEYWORD and tok.text in ("REPLACE", "END", "FILTER")
        ):
            return self._parse_ident_expr()
        raise ParseError(f"unexpected token {tok.text!r} at position {tok.pos}")

    def _parse_wildcard(self) -> ast.Expr:
        wc = ast.Wildcard()
        while True:
            if self.ts.at_keyword("EXCEPT"):
                self.ts.next()
                self.ts.expect(OP, "(")
                wc.except_names.append(self._ident_like())
                while self.ts.accept(OP, ","):
                    wc.except_names.append(self._ident_like())
                self.ts.expect(OP, ")")
            elif self.ts.at_keyword("REPLACE"):
                self.ts.next()
                self.ts.expect(OP, "(")
                while True:
                    expr = self.parse_expr()
                    self.ts.expect(KEYWORD, "AS")
                    alias = self._ident_like()
                    wc.replaces.append(ast.Field(expr=expr, name=alias, alias=alias))
                    if not self.ts.accept(OP, ","):
                        break
                self.ts.expect(OP, ")")
            else:
                return wc

    def _parse_ident_expr(self) -> ast.Expr:
        name = self._ident_like()
        if self.ts.accept(OP, "("):
            return self._parse_call(name)
        stream = ""
        if self.ts.peek().kind == OP and self.ts.peek().text == ".":
            nxt = self.ts.peek(1)
            if nxt.kind == IDENT:
                self.ts.next()
                stream, name = name, self.ts.next().text
            elif nxt.kind == OP and nxt.text == "*":
                self.ts.next()
                self.ts.next()
                return ast.Wildcard(stream=name)  # stream.* — one stream's cols
        return ast.FieldRef(name=name, stream=stream)

    def _parse_call(self, name: str) -> ast.Expr:
        lname = name.lower()
        args: List[ast.Expr] = []
        if not (self.ts.peek().kind == OP and self.ts.peek().text == ")"):
            while True:
                args.append(self._parse_call_arg(lname))
                if not self.ts.accept(OP, ","):
                    break
        self.ts.expect(OP, ")")
        call = ast.Call(name=lname, args=args, func_id=self._func_id)
        self._func_id += 1
        # parse-time arg validation against the function registry, mirroring
        # the reference's parseCall -> binder lookup (parser.go:889)
        if lname not in WINDOW_FUNCS:
            from ..functions import registry as _freg

            fd = _freg.lookup(lname)
            if fd is not None and fd.val is not None:
                err = fd.val(args)
                if err:
                    raise ParseError(f"{lname}: {err}")
        # FILTER ( WHERE expr )
        if self.ts.at_keyword("FILTER"):
            self.ts.next()
            self.ts.expect(OP, "(")
            self.ts.expect(KEYWORD, "WHERE")
            call.filter = self.parse_expr()
            self.ts.expect(OP, ")")
        # OVER ( [PARTITION BY e, ...] [WHEN cond] )
        if self.ts.at_keyword("OVER"):
            self.ts.next()
            self.ts.expect(OP, "(")
            if self.ts.accept(KEYWORD, "PARTITION"):
                self.ts.expect(KEYWORD, "BY")
                call.partition.append(self.parse_expr())
                while self.ts.accept(OP, ","):
                    call.partition.append(self.parse_expr())
            if self.ts.accept(KEYWORD, "WHEN"):
                call.when = self.parse_expr()
            self.ts.expect(OP, ")")
        return call

    def _parse_call_arg(self, func_name: str) -> ast.Expr:
        tok = self.ts.peek()
        # time-unit literal as first arg of window funcs: tumblingwindow(ss, 10)
        if (
            func_name in WINDOW_FUNCS
            and tok.kind == IDENT
            and tok.text.upper() in TIME_UNITS
        ):
            self.ts.next()
            return ast.TimeLiteral(tok.text.upper())
        return self.parse_expr()

    def parse_case(self) -> ast.Expr:
        self.ts.expect(KEYWORD, "CASE")
        value: Optional[ast.Expr] = None
        if not self.ts.at_keyword("WHEN"):
            value = self.parse_expr()
        whens: List[ast.WhenClause] = []
        while self.ts.accept(KEYWORD, "WHEN"):
            cond = self.parse_expr()
            self.ts.expect(KEYWORD, "THEN")
            result = self.parse_expr()
            whens.append(ast.WhenClause(cond=cond, result=result))
        if not whens:
            raise ParseError("CASE requires at least one WHEN clause")
        else_expr: Optional[ast.Expr] = None
        if self.ts.accept(KEYWORD, "ELSE"):
            else_expr = self.parse_expr()
        self.ts.expect(KEYWORD, "END")
        return ast.CaseExpr(value=value, whens=whens, else_expr=else_expr)

    # ------------------------------------------------------------------- DDL
    def parse_create(self) -> ast.StreamStmt:
        self.ts.expect(KEYWORD, "CREATE")
        is_table = False
        if self.ts.accept(KEYWORD, "TABLE"):
            is_table = True
        else:
            self.ts.expect(KEYWORD, "STREAM")
        name = self._ident_like()
        self.ts.expect(OP, "(")
        fields: List[ast.StreamField] = []
        if not (self.ts.peek().kind == OP and self.ts.peek().text == ")"):
            while True:
                fields.append(self._parse_stream_field())
                if not self.ts.accept(OP, ","):
                    break
        self.ts.expect(OP, ")")
        self.ts.expect(KEYWORD, "WITH")
        self.ts.expect(OP, "(")
        options = self._parse_stream_options()
        self.ts.expect(OP, ")")
        return ast.StreamStmt(name=name, fields=fields, options=options, is_table=is_table)

    def _parse_stream_field(self) -> ast.StreamField:
        fname = self._ident_like()
        return ast.StreamField(name=fname, **self._parse_field_type())

    def _parse_field_type(self) -> dict:
        tok = self.ts.peek()
        tname = tok.text.upper() if tok.kind in (IDENT, KEYWORD) else ""
        if tname not in _TYPE_NAMES:
            raise ParseError(f"invalid field type {tok.text!r} at {tok.pos}")
        self.ts.next()
        dt = _TYPE_NAMES[tname]
        if dt == DataType.ARRAY:
            self.ts.expect(OP, "(")
            elem = self._parse_field_type()
            if elem["fields"]:
                # array of struct: keep struct fields on the array field
                out = {"type": dt, "elem_type": elem["type"], "fields": elem["fields"]}
            else:
                out = {"type": dt, "elem_type": elem["type"], "fields": []}
            self.ts.expect(OP, ")")
            return out
        if dt == DataType.STRUCT:
            self.ts.expect(OP, "(")
            subs: List[ast.StreamField] = []
            while True:
                subs.append(self._parse_stream_field())
                if not self.ts.accept(OP, ","):
                    break
            self.ts.expect(OP, ")")
            return {"type": dt, "elem_type": None, "fields": subs}
        return {"type": dt, "elem_type": None, "fields": []}

    def _parse_stream_options(self) -> ast.StreamOptions:
        opts = ast.StreamOptions()
        bool_keys = {"strict_validation", "shared"}
        int_keys = {"retain_size"}
        if self.ts.peek().kind == OP and self.ts.peek().text == ")":
            return opts
        while True:
            key = self._ident_like().lower()
            self.ts.expect(OP, "=")
            tok = self.ts.next()
            if tok.kind == STRING:
                raw = tok.text
            elif tok.kind == KEYWORD and tok.text in ("TRUE", "FALSE"):
                raw = tok.text.lower()
            elif tok.kind in (INTEGER, NUMBER, IDENT):
                raw = tok.text
            else:
                raise ParseError(f"invalid option value {tok.text!r} at {tok.pos}")
            if not hasattr(opts, key):
                raise ParseError(f"unknown stream option {key.upper()}")
            if key in bool_keys:
                setattr(opts, key, raw.lower() in ("true", "1"))
            elif key in int_keys:
                setattr(opts, key, int(raw))
            else:
                setattr(opts, key, raw)
            if not self.ts.accept(OP, ","):
                break
        return opts

    # -------------------------------------------------------------- management
    def parse_show(self) -> ast.ShowStmt:
        self.ts.expect(KEYWORD, "SHOW")
        if self.ts.accept(KEYWORD, "STREAMS"):
            return ast.ShowStmt(target="STREAMS")
        self.ts.expect(KEYWORD, "TABLES")
        return ast.ShowStmt(target="TABLES")

    def parse_describe(self) -> ast.DescribeStmt:
        self.ts.next()  # DESCRIBE | DESC
        target = "TABLE" if self.ts.accept(KEYWORD, "TABLE") else None
        if target is None:
            self.ts.expect(KEYWORD, "STREAM")
            target = "STREAM"
        return ast.DescribeStmt(target=target, name=self._ident_like())

    def parse_drop(self) -> ast.DropStmt:
        self.ts.expect(KEYWORD, "DROP")
        target = "TABLE" if self.ts.accept(KEYWORD, "TABLE") else None
        if target is None:
            self.ts.expect(KEYWORD, "STREAM")
            target = "STREAM"
        return ast.DropStmt(target=target, name=self._ident_like())

    def parse_explain(self) -> ast.ExplainStmt:
        self.ts.expect(KEYWORD, "EXPLAIN")
        target = "TABLE" if self.ts.accept(KEYWORD, "TABLE") else None
        if target is None:
            self.ts.expect(KEYWORD, "STREAM")
            target = "STREAM"
        return ast.ExplainStmt(target=target, name=self._ident_like())


def parse(sql: str) -> ast.Statement:
    """Parse one statement (analogue of xsql.GetStatementFromSql)."""
    return Parser(sql).parse()


def parse_select(sql: str) -> ast.SelectStatement:
    stmt = parse(sql)
    if not isinstance(stmt, ast.SelectStatement):
        raise ParseError("expected a SELECT statement")
    return stmt
