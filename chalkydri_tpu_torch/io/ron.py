"""Minimal RON (Rusty Object Notation) parser/serializer.

The reference's dataflow graph topology IS configuration, written in RON
(``chalkydri.ron:1-157``, ``config/calibration.ron``,
``crates/chalkydri/copperconfig.ron``) and consumed by Copper's
``#[copper_runtime]`` macro at compile time. To preserve that config surface
this module parses the RON subset those files use:

- anonymous struct bodies ``( field: value, ... )`` -> dict
- lists ``[ ... ]`` -> list
- maps ``{ "key": value, ... }`` -> dict
- strings (with escapes), integers, floats, booleans
- ``None`` -> None, ``Some(x)`` -> x, bare identifiers -> str

Unlike the reference (which must recompile the binary when the graph
changes, ``book/src/internals/index.md:5-7``), this runtime loads the
graph at startup.
"""

from __future__ import annotations


class RonError(ValueError):
    pass


class _Parser:
    def __init__(self, text: str):
        self.t = text
        self.i = 0
        self.n = len(text)

    # -- lexing helpers -----------------------------------------------------

    def _skip_ws(self):
        while self.i < self.n:
            c = self.t[self.i]
            if c in " \t\r\n":
                self.i += 1
            elif c == "/" and self.i + 1 < self.n and self.t[self.i + 1] == "/":
                while self.i < self.n and self.t[self.i] != "\n":
                    self.i += 1
            elif c == "/" and self.i + 1 < self.n and self.t[self.i + 1] == "*":
                self.i += 2
                while self.i + 1 < self.n and not (
                    self.t[self.i] == "*" and self.t[self.i + 1] == "/"
                ):
                    self.i += 1
                self.i += 2
            else:
                return

    def _peek(self):
        self._skip_ws()
        if self.i >= self.n:
            raise RonError("unexpected end of input")
        return self.t[self.i]

    def _expect(self, ch: str):
        if self._peek() != ch:
            raise RonError(
                f"expected {ch!r} at offset {self.i}, got {self.t[self.i]!r}"
            )
        self.i += 1

    def _ident(self) -> str:
        self._skip_ws()
        start = self.i
        while self.i < self.n and (self.t[self.i].isalnum() or self.t[self.i] in "_"):
            self.i += 1
        if start == self.i:
            raise RonError(f"expected identifier at offset {self.i}")
        return self.t[start : self.i]

    # -- values -------------------------------------------------------------

    def value(self):
        c = self._peek()
        if c == "(":
            return self._struct()
        if c == "[":
            return self._list()
        if c == "{":
            return self._map()
        if c == '"':
            return self._string()
        if c.isdigit() or c in "+-.":
            return self._number()
        ident = self._ident()
        if ident == "None":
            return None
        if ident in ("true", "false"):
            return ident == "true"
        if ident == "Some":
            self._expect("(")
            inner = self.value()
            self._expect(")")
            return inner
        # bare identifier (enum variant / type name)
        return ident

    def _struct(self) -> dict:
        self._expect("(")
        out = {}
        while True:
            if self._peek() == ")":
                self.i += 1
                return out
            key = self._ident()
            self._expect(":")
            out[key] = self.value()
            if self._peek() == ",":
                self.i += 1

    def _list(self) -> list:
        self._expect("[")
        out = []
        while True:
            if self._peek() == "]":
                self.i += 1
                return out
            out.append(self.value())
            if self._peek() == ",":
                self.i += 1

    def _map(self) -> dict:
        self._expect("{")
        out = {}
        while True:
            if self._peek() == "}":
                self.i += 1
                return out
            key = self.value()
            self._expect(":")
            out[key] = self.value()
            if self._peek() == ",":
                self.i += 1

    def _string(self) -> str:
        self._expect('"')
        buf = []
        while self.i < self.n:
            c = self.t[self.i]
            self.i += 1
            if c == "\\":
                esc = self.t[self.i]
                self.i += 1
                buf.append(
                    {"n": "\n", "t": "\t", "r": "\r", '"': '"', "\\": "\\", "0": "\0"}.get(
                        esc, esc
                    )
                )
            elif c == '"':
                return "".join(buf)
            else:
                buf.append(c)
        raise RonError("unterminated string")

    def _number(self):
        self._skip_ws()
        start = self.i
        while self.i < self.n and (self.t[self.i].isdigit() or self.t[self.i] in "+-.eE_x"):
            self.i += 1
        tok = self.t[start : self.i].replace("_", "")
        try:
            if any(c in tok for c in ".eE") and "x" not in tok:
                return float(tok)
            return int(tok, 0)
        except ValueError as e:
            raise RonError(f"bad number {tok!r} at offset {start}") from e


def loads(text: str):
    p = _Parser(text)
    v = p.value()
    p._skip_ws()
    if p.i != p.n:
        raise RonError(f"trailing data at offset {p.i}")
    return v


def load(path: str):
    with open(path) as f:
        return loads(f.read())


def _dump_value(v, indent: int) -> str:
    pad = "    " * indent
    pad2 = "    " * (indent + 1)
    if v is None:
        return "None"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n") + '"'
    if isinstance(v, list):
        if not v:
            return "[]"
        items = ",\n".join(pad2 + _dump_value(x, indent + 1) for x in v)
        return "[\n" + items + ",\n" + pad + "]"
    if isinstance(v, dict):
        if not v:
            return "{}"
        # Heuristic matching the reference files: identifier keys -> struct
        # syntax, quoted keys -> map syntax.
        all_ident = all(
            isinstance(k, str) and k.replace("_", "a").isalnum() and not k[0].isdigit()
            and v.get("__ron_map__") is None
            for k in v
        ) and not v.get("__force_map__", False)
        items = []
        for k, val in v.items():
            if k in ("__force_map__",):
                continue
            if all_ident:
                items.append(f"{pad2}{k}: {_dump_value(val, indent + 1)}")
            else:
                ks = _dump_value(str(k), indent + 1)
                items.append(f"{pad2}{ks}: {_dump_value(val, indent + 1)}")
        body = ",\n".join(items)
        if all_ident:
            return "(\n" + body + ",\n" + pad + ")"
        return "{\n" + body + ",\n" + pad + "}"
    raise TypeError(f"cannot serialize {type(v)}")


def dumps(v) -> str:
    """Serialize to RON (struct syntax for identifier-keyed dicts, map syntax
    otherwise; set ``{"__force_map__": True}`` to force map syntax)."""
    return _dump_value(v, 0) + "\n"


def dump(v, path: str) -> None:
    with open(path, "w") as f:
        f.write(dumps(v))
