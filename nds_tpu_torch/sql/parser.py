"""Recursive-descent SQL parser for the TPC dialect subset.

Port copy of ``nds_tpu/sql/parser.py``: it imports nothing of ``nds_tpu``.

Grammar coverage is driven by the benchmark queries (see ast.py). The
Spark-dialect quirks the reference bakes into its template patches
(`nds/tpcds-gen/patches/templates.patch`: `+ interval N days`, backtick
aliases; `nds-h/tpch-gen/patches/template.patch`: plain `;` termination)
are accepted natively here.
"""

from __future__ import annotations

from nds_tpu_torch.sql import ast
from nds_tpu_torch.sql.lexer import Token, tokenize

_KEYWORDS_NONIDENT = {
    "select", "from", "where", "group", "order", "by", "having", "limit",
    "union", "intersect", "except", "join", "inner", "left", "right", "full",
    "outer", "cross", "on", "as", "and", "or", "not", "in", "exists",
    "between", "like", "is", "null", "case", "when", "then", "else", "end",
    "distinct", "asc", "desc", "with",
}


class ParseError(ValueError):
    def __init__(self, msg: str, tok: Token | None = None):
        if tok is not None:
            msg = f"{msg} (at {tok.pos}: {tok.value!r})"
        super().__init__(msg)


class Parser:
    def __init__(self, sql: str):
        self.tokens = tokenize(sql)
        self.i = 0

    # --- token helpers -----------------------------------------------------

    def peek(self, ahead: int = 0) -> Token:
        return self.tokens[min(self.i + ahead, len(self.tokens) - 1)]

    def next(self) -> Token:
        t = self.tokens[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "ident" and t.value.lower() in kws

    def take_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.take_kw(kw):
            raise ParseError(f"expected {kw.upper()}", self.peek())

    def at_punct(self, p: str) -> bool:
        t = self.peek()
        return t.kind in ("punct", "op") and t.value == p

    def take_punct(self, p: str) -> bool:
        if self.at_punct(p):
            self.next()
            return True
        return False

    def expect_punct(self, p: str) -> None:
        if not self.take_punct(p):
            raise ParseError(f"expected {p!r}", self.peek())

    # --- entry -------------------------------------------------------------

    def parse_statement(self):
        if self.at_kw("create"):
            self.next()
            self.take_kw("temp") or self.take_kw("temporary")
            self.expect_kw("view")
            name = self.next().value.lower()
            columns: list[str] = []
            if self.take_punct("("):
                while True:
                    columns.append(self.next().value.lower())
                    if not self.take_punct(","):
                        break
                self.expect_punct(")")
            self.expect_kw("as")
            q = self._parse_query()
            self.take_punct(";")
            return ast.CreateView(name, columns, q)
        if self.at_kw("drop"):
            self.next()
            self.expect_kw("view")
            if_exists = False
            if self.take_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            name = self.next().value.lower()
            self.take_punct(";")
            return ast.DropView(name, if_exists)
        if self.at_kw("insert"):
            self.next()
            self.expect_kw("into")
            name = self.next().value.lower()
            wrapped = self.take_punct("(")
            q = self._parse_query()
            if wrapped:
                self.expect_punct(")")
            self.take_punct(";")
            t = self.peek()
            if t.kind != "eof":
                raise ParseError("trailing tokens after INSERT", t)
            return ast.Insert(name, q)
        if self.at_kw("delete"):
            self.next()
            self.expect_kw("from")
            name = self.next().value.lower()
            where = None
            if self.take_kw("where"):
                where = self.parse_expr()
            self.take_punct(";")
            t = self.peek()
            if t.kind != "eof":
                raise ParseError("trailing tokens after DELETE", t)
            return ast.Delete(name, where)
        sel = self._parse_query()
        self.take_punct(";")
        t = self.peek()
        if t.kind != "eof":
            raise ParseError("trailing tokens after statement", t)
        return sel

    def _parse_query(self) -> ast.Select:
        """[WITH ctes] select — the query body shared by top-level
        statements, CREATE VIEW ... AS, and INSERT INTO ... (query)."""
        ctes: dict[str, ast.Select] = {}
        if self.take_kw("with"):
            while True:
                name = self.next().value
                self.expect_kw("as")
                self.expect_punct("(")
                ctes[name.lower()] = self.parse_select()
                self.expect_punct(")")
                if not self.take_punct(","):
                    break
        sel = self.parse_select()
        sel.ctes.update(ctes)
        return sel

    def parse_select(self) -> ast.Select:
        sel = self._parse_simple_select()
        # set operations bind left-to-right
        while self.at_kw("union", "intersect", "except"):
            op = self.next().value.lower()
            if op == "union" and self.take_kw("all"):
                op = "union all"
            elif self.take_kw("distinct"):
                pass  # distinct is the default semantics
            rhs = self._parse_simple_select()
            # a trailing ORDER BY / LIMIT binds to the whole set operation,
            # not the last branch — hoist it out of the rhs
            if rhs.order_by or rhs.limit is not None:
                sel.order_by, rhs.order_by = rhs.order_by, []
                sel.limit, rhs.limit = rhs.limit, None
            sel.set_ops.append((op, rhs))
        # ORDER BY / LIMIT after a set operation applies to the whole result
        if self.at_kw("order"):
            self._parse_order_limit(sel)
        return sel

    def _parse_simple_select(self) -> ast.Select:
        if self.take_punct("("):
            sel = self.parse_select()
            self.expect_punct(")")
            return sel
        self.expect_kw("select")
        sel = ast.Select()
        sel.distinct = bool(self.take_kw("distinct"))
        self.take_kw("all")
        # select list
        while True:
            sel.items.append(self._parse_select_item())
            if not self.take_punct(","):
                break
        if self.take_kw("from"):
            sel.from_tables.append(self._parse_table_factor())
            while True:
                if self.take_punct(","):
                    sel.from_tables.append(self._parse_table_factor())
                    continue
                join_kind = self._maybe_join_kind()
                if join_kind is None:
                    break
                table = self._parse_table_factor()
                on = None
                if self.take_kw("on"):
                    on = self.parse_expr()
                sel.joins.append(ast.JoinClause(join_kind, table, on))
        if self.take_kw("where"):
            sel.where = self.parse_expr()
        if self.at_kw("group"):
            self.next()
            self.expect_kw("by")
            self._parse_group_by(sel)
        if self.take_kw("having"):
            sel.having = self.parse_expr()
        self._parse_order_limit(sel)
        return sel

    def _parse_group_by(self, sel: ast.Select) -> None:
        """Plain list, ROLLUP(...), CUBE(...), or GROUPING SETS((..),..).
        All lower to sel.group_by (the full key list) + sel.grouping_sets
        (index lists), matching the Spark dialect the reference's patched
        templates use (`nds/tpcds-gen/patches/templates.patch`)."""
        if self.at_kw("rollup") or self.at_kw("cube"):
            kind = self.next().value.lower()
            self.expect_punct("(")
            keys = [self.parse_expr()]
            while self.take_punct(","):
                keys.append(self.parse_expr())
            self.expect_punct(")")
            sel.group_by = keys
            n = len(keys)
            if kind == "rollup":
                sel.grouping_sets = [list(range(k))
                                     for k in range(n, -1, -1)]
            else:  # cube: all subsets, spec enumeration order
                sel.grouping_sets = [
                    [i for i in range(n) if mask & (1 << i)]
                    for mask in range((1 << n) - 1, -1, -1)]
            return
        if self.at_kw("grouping"):
            save = self.i
            self.next()
            if not self.take_kw("sets"):
                self.i = save
            else:
                self.expect_punct("(")
                keys: list = []
                key_index: dict = {}
                sets: list[list[int]] = []
                while True:
                    self.expect_punct("(")
                    one: list[int] = []
                    if not self.at_punct(")"):
                        while True:
                            e = self.parse_expr()
                            r = repr(e)
                            if r not in key_index:
                                key_index[r] = len(keys)
                                keys.append(e)
                            one.append(key_index[r])
                            if not self.take_punct(","):
                                break
                    self.expect_punct(")")
                    sets.append(one)
                    if not self.take_punct(","):
                        break
                self.expect_punct(")")
                sel.group_by = keys
                sel.grouping_sets = sets
                return
        while True:
            sel.group_by.append(self.parse_expr())
            if not self.take_punct(","):
                break

    def _parse_order_limit(self, sel: ast.Select) -> None:
        if self.at_kw("order"):
            self.next()
            self.expect_kw("by")
            while True:
                e = self.parse_expr()
                asc = True
                if self.take_kw("desc"):
                    asc = False
                else:
                    self.take_kw("asc")
                nulls_first = None
                if self.take_kw("nulls"):
                    nulls_first = bool(self.take_kw("first"))
                    if nulls_first is False:
                        self.expect_kw("last")
                sel.order_by.append(ast.OrderItem(e, asc, nulls_first))
                if not self.take_punct(","):
                    break
        if self.take_kw("limit"):
            t = self.next()
            if t.kind != "number":
                raise ParseError("expected LIMIT count", t)
            sel.limit = int(t.value)

    def _maybe_join_kind(self) -> str | None:
        if self.at_kw("join"):
            self.next()
            return "inner"
        for kw, kind in (("inner", "inner"), ("left", "left"),
                         ("right", "right"), ("full", "full"),
                         ("cross", "cross")):
            if self.at_kw(kw):
                save = self.i
                self.next()
                self.take_kw("outer")
                if self.take_kw("join"):
                    return kind
                self.i = save
                return None
        return None

    def _parse_table_factor(self):
        if self.take_punct("("):
            sub = self.parse_select()
            self.expect_punct(")")
            self.take_kw("as")
            alias_t = self.next()
            if alias_t.kind != "ident":
                raise ParseError("derived table requires an alias", alias_t)
            return ast.SubqueryRef(sub, alias_t.value.lower())
        t = self.next()
        if t.kind != "ident":
            raise ParseError("expected table name", t)
        name = t.value.lower()
        alias = None
        if self.take_kw("as"):
            alias = self.next().value.lower()
        elif (self.peek().kind == "ident"
              and self.peek().value.lower() not in _KEYWORDS_NONIDENT):
            alias = self.next().value.lower()
        return ast.TableRef(name, alias)

    def _parse_select_item(self) -> ast.SelectItem:
        if self.at_punct("*"):
            self.next()
            return ast.SelectItem(ast.Star())
        # table.* form
        if (self.peek().kind == "ident" and self.peek(1).value == "."
                and self.peek(2).value == "*"):
            table = self.next().value.lower()
            self.next()
            self.next()
            return ast.SelectItem(ast.Star(table))
        e = self.parse_expr()
        alias = None
        if self.take_kw("as"):
            alias = self.next().value.lower()
        elif (self.peek().kind == "ident"
              and self.peek().value.lower() not in _KEYWORDS_NONIDENT):
            alias = self.next().value.lower()
        return ast.SelectItem(e, alias)

    # --- expressions -------------------------------------------------------

    def parse_expr(self) -> ast.Expr:
        return self._parse_or()

    def _parse_or(self) -> ast.Expr:
        left = self._parse_and()
        while self.take_kw("or"):
            left = ast.BinOp("or", left, self._parse_and())
        return left

    def _parse_and(self) -> ast.Expr:
        left = self._parse_not()
        while self.take_kw("and"):
            left = ast.BinOp("and", left, self._parse_not())
        return left

    def _parse_not(self) -> ast.Expr:
        if self.take_kw("not"):
            return ast.UnaryOp("not", self._parse_not())
        return self._parse_comparison()

    def _parse_comparison(self) -> ast.Expr:
        left = self._parse_additive()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("=", "<>", "!=", "<", "<=", ">", ">="):
                self.next()
                op = "<>" if t.value == "!=" else t.value
                left = ast.BinOp(op, left, self._parse_additive())
                continue
            negated = False
            save = self.i
            if self.take_kw("not"):
                negated = True
            if self.take_kw("between"):
                low = self._parse_additive()
                self.expect_kw("and")
                high = self._parse_additive()
                left = ast.Between(left, low, high, negated)
                continue
            if self.take_kw("in"):
                self.expect_punct("(")
                if self.at_kw("select", "with"):
                    sub = self.parse_select()
                    self.expect_punct(")")
                    left = ast.InSubquery(left, sub, negated)
                else:
                    items = [self.parse_expr()]
                    while self.take_punct(","):
                        items.append(self.parse_expr())
                    self.expect_punct(")")
                    left = ast.InList(left, items, negated)
                continue
            if self.take_kw("like"):
                t = self.next()
                if t.kind != "string":
                    raise ParseError("LIKE requires a string pattern", t)
                left = ast.Like(left, t.value, negated)
                continue
            if negated:
                self.i = save  # NOT belonged to something else
                break
            if self.take_kw("is"):
                neg = bool(self.take_kw("not"))
                self.expect_kw("null")
                left = ast.IsNull(left, neg)
                continue
            break
        return left

    def _parse_additive(self) -> ast.Expr:
        left = self._parse_multiplicative()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value == "||":
                self.next()
                left = ast.FuncCall(
                    "concat", [left, self._parse_multiplicative()])
                continue
            if t.kind == "op" and t.value in ("+", "-"):
                self.next()
                left = ast.BinOp(t.value, left, self._parse_multiplicative())
            else:
                return left

    def _parse_multiplicative(self) -> ast.Expr:
        left = self._parse_unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/", "%"):
                self.next()
                left = ast.BinOp(t.value, left, self._parse_unary())
            else:
                return left

    def _parse_unary(self) -> ast.Expr:
        t = self.peek()
        if t.kind == "op" and t.value == "-":
            self.next()
            return ast.UnaryOp("-", self._parse_unary())
        if t.kind == "op" and t.value == "+":
            self.next()
            return self._parse_unary()
        return self._parse_primary()

    def _parse_primary(self) -> ast.Expr:
        t = self.peek()
        if t.kind == "number":
            self.next()
            if "." in t.value:
                return ast.Literal(t.value, "decimal")
            return ast.Literal(int(t.value), "int")
        if t.kind == "string":
            self.next()
            return ast.Literal(t.value, "string")
        if self.take_punct("("):
            if self.at_kw("select", "with"):
                sub = self.parse_select()
                self.expect_punct(")")
                return ast.ScalarSubquery(sub)
            e = self.parse_expr()
            self.expect_punct(")")
            return e
        if t.kind != "ident":
            raise ParseError("unexpected token in expression", t)
        word = t.value.lower()
        if word == "case":
            return self._parse_case()
        if word == "exists":
            self.next()
            self.expect_punct("(")
            sub = self.parse_select()
            self.expect_punct(")")
            return ast.Exists(sub)
        if word == "null":
            self.next()
            return ast.Literal(None, "null")
        if word == "date" and self.peek(1).kind == "string":
            self.next()
            return ast.Literal(self.next().value, "date")
        if word == "interval":
            self.next()
            amt_t = self.next()
            if amt_t.kind == "string":
                amount = int(amt_t.value)
            elif amt_t.kind == "number":
                amount = int(amt_t.value)
            else:
                raise ParseError("expected interval amount", amt_t)
            unit_t = self.next()
            unit = unit_t.value.lower().rstrip("s")
            if unit not in ("day", "month", "year"):
                raise ParseError(f"unsupported interval unit {unit!r}", unit_t)
            return ast.Interval(amount, unit)
        if word == "extract":
            self.next()
            self.expect_punct("(")
            part = self.next().value.lower()
            self.expect_kw("from")
            operand = self.parse_expr()
            self.expect_punct(")")
            return ast.Extract(part, operand)
        if word == "substring" or word == "substr":
            self.next()
            self.expect_punct("(")
            operand = self.parse_expr()
            if self.take_kw("from"):
                start = self.parse_expr()
                length = None
                if self.take_kw("for"):
                    length = self.parse_expr()
            else:
                self.expect_punct(",")
                start = self.parse_expr()
                length = None
                if self.take_punct(","):
                    length = self.parse_expr()
            self.expect_punct(")")
            return ast.Substring(operand, start, length)
        if word == "cast":
            self.next()
            self.expect_punct("(")
            operand = self.parse_expr()
            self.expect_kw("as")
            type_name = self.next().value.lower()
            if self.take_punct("("):  # e.g. decimal(12,2)
                while not self.take_punct(")"):
                    self.next()
            self.expect_punct(")")
            return ast.Cast(operand, type_name)
        if word in _KEYWORDS_NONIDENT:
            raise ParseError("unexpected keyword in expression", t)
        # function call or column reference
        if self.peek(1).value == "(" and self.peek(1).kind == "punct":
            name = self.next().value.lower()
            self.next()  # (
            if self.take_punct("*"):
                self.expect_punct(")")
                return self._maybe_window(ast.FuncCall(name, star=True))
            if self.take_punct(")"):
                return self._maybe_window(ast.FuncCall(name))
            distinct = bool(self.take_kw("distinct"))
            args = [self.parse_expr()]
            while self.take_punct(","):
                args.append(self.parse_expr())
            self.expect_punct(")")
            return self._maybe_window(
                ast.FuncCall(name, args, distinct))
        # column, possibly qualified
        name = self.next().value.lower()
        if self.at_punct(".") and self.peek(1).kind == "ident":
            self.next()
            col = self.next().value.lower()
            return ast.Column(col, name)
        return ast.Column(name)

    def _maybe_window(self, fc: ast.FuncCall) -> ast.Expr:
        """fc [OVER (PARTITION BY ... ORDER BY ... [ROWS ...])]."""
        if not self.at_kw("over"):
            return fc
        if fc.distinct:
            raise ParseError(
                f"DISTINCT window aggregate {fc.name} is unsupported")
        self.next()
        self.expect_punct("(")
        partition: list[ast.Expr] = []
        order: list[ast.OrderItem] = []
        frame = None
        if self.take_kw("partition"):
            self.expect_kw("by")
            partition.append(self.parse_expr())
            while self.take_punct(","):
                partition.append(self.parse_expr())
        if self.at_kw("order"):
            self.next()
            self.expect_kw("by")
            while True:
                e = self.parse_expr()
                asc = True
                if self.take_kw("desc"):
                    asc = False
                else:
                    self.take_kw("asc")
                nulls_first = None
                if self.take_kw("nulls"):
                    nulls_first = bool(self.take_kw("first"))
                    if nulls_first is False:
                        self.expect_kw("last")
                order.append(ast.OrderItem(e, asc, nulls_first))
                if not self.take_punct(","):
                    break
        if self.take_kw("rows"):
            # the workload's only frame: running aggregate (q51)
            self.expect_kw("between")
            self.expect_kw("unbounded")
            self.expect_kw("preceding")
            self.expect_kw("and")
            self.expect_kw("current")
            self.expect_kw("row")
            frame = "cum"
        self.expect_punct(")")
        return ast.WindowFunc(fc.name, [] if fc.star else fc.args,
                              partition, order, frame)

    def _parse_case(self) -> ast.Expr:
        self.expect_kw("case")
        operand = None
        if not self.at_kw("when"):
            operand = self.parse_expr()
        whens: list[tuple[ast.Expr, ast.Expr]] = []
        while self.take_kw("when"):
            cond = self.parse_expr()
            if operand is not None:
                cond = ast.BinOp("=", operand, cond)
            self.expect_kw("then")
            whens.append((cond, self.parse_expr()))
        else_ = None
        if self.take_kw("else"):
            else_ = self.parse_expr()
        self.expect_kw("end")
        return ast.CaseWhen(whens, else_)


def parse(sql: str) -> ast.Select:
    return Parser(sql).parse_statement()
