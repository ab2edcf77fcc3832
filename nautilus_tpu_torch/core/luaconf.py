"""Lua-subset config interpreter — keeps the reference's config/*.lua surface.

The reference binds ~45 Lua keys to typed globals via its config-reader
submodule (reference src/optimization/solver.h:32-65, src/main.cc:33-39,
src/input/slam_type_builder.h:17-23, src/input/normal_computation.h:12-17) and
its config files are executable Lua (arithmetic, math.pi, references to earlier
keys — e.g. reference config/default_config.lua:72-77).  Per-robot configs
include the defaults via ``dofile(debug.getinfo(1).source:match(...) ..
'/default_config.lua')`` or ``require("config.default_config")`` and then
override keys.

This module interprets exactly that subset without a Lua runtime:
- line/block comments (``--``, ``--[[ ... ]]--``)
- ``key = expr`` assignments at file scope
- expressions: numbers, strings, booleans, ``math.pi``, ``math.*`` calls,
  ``+ - * / % ^``, unary minus, parentheses, identifiers (earlier keys),
  string concatenation ``..``
- ``dofile(<anything containing a quoted filename>.lua)`` and
  ``require("config.name")`` resolved relative to the config file / repo.

Values keep Lua semantics: all numbers are floats, strings, booleans.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple


class LuaConfigError(ValueError):
    pass


_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<number>\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?)
  | (?P<concat>\.\.)
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*(?:\.[A-Za-z_][A-Za-z0-9_]*)*)
  | (?P<string>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
  | (?P<op>[+\-*/%^(),])
    """,
    re.VERBOSE,
)


def _tokenize(expr: str) -> List[Tuple[str, str]]:
    tokens = []
    pos = 0
    while pos < len(expr):
        m = _TOKEN_RE.match(expr, pos)
        if m is None:
            raise LuaConfigError(f"Cannot tokenize config expression at: {expr[pos:]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        tokens.append((kind, m.group()))
    return tokens


_MATH_FNS = {
    "math.pi": math.pi,
    "math.huge": math.inf,
}
_MATH_CALLS = {
    "math.sqrt": math.sqrt,
    "math.abs": abs,
    "math.floor": math.floor,
    "math.ceil": math.ceil,
    "math.sin": math.sin,
    "math.cos": math.cos,
    "math.tan": math.tan,
    "math.rad": math.radians,
    "math.deg": math.degrees,
    "math.min": min,
    "math.max": max,
}


class _ExprParser:
    """Recursive-descent parser for the Lua expression subset."""

    def __init__(self, tokens: List[Tuple[str, str]], env: Dict[str, Any]):
        self.tokens = tokens
        self.pos = 0
        self.env = env

    def peek(self) -> Optional[Tuple[str, str]]:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self) -> Tuple[str, str]:
        tok = self.peek()
        if tok is None:
            raise LuaConfigError("Unexpected end of expression")
        self.pos += 1
        return tok

    def expect(self, value: str):
        tok = self.next()
        if tok[1] != value:
            raise LuaConfigError(f"Expected {value!r}, got {tok[1]!r}")

    def parse(self) -> Any:
        val = self.parse_concat()
        if self.peek() is not None:
            raise LuaConfigError(f"Trailing tokens in expression: {self.tokens[self.pos:]}")
        return val

    def parse_concat(self) -> Any:
        val = self.parse_additive()
        while (tok := self.peek()) and tok[0] == "concat":
            self.next()
            rhs = self.parse_additive()
            val = _lua_str(val) + _lua_str(rhs)
        return val

    def parse_additive(self) -> Any:
        val = self.parse_multiplicative()
        while (tok := self.peek()) and tok[1] in "+-":
            op = self.next()[1]
            rhs = self.parse_multiplicative()
            val = val + rhs if op == "+" else val - rhs
        return val

    def parse_multiplicative(self) -> Any:
        val = self.parse_unary()
        while (tok := self.peek()) and tok[1] in "*/%":
            op = self.next()[1]
            rhs = self.parse_unary()
            if op == "*":
                val = val * rhs
            elif op == "/":
                val = val / rhs
            else:
                val = math.fmod(val, rhs)
        return val

    def parse_unary(self) -> Any:
        tok = self.peek()
        if tok and tok[1] == "-":
            self.next()
            return -self.parse_unary()
        return self.parse_power()

    def parse_power(self) -> Any:
        base = self.parse_atom()
        if (tok := self.peek()) and tok[1] == "^":
            self.next()
            return base ** self.parse_unary()  # right-assoc
        return base

    def parse_atom(self) -> Any:
        kind, value = self.next()
        if kind == "number":
            return float(value)
        if kind == "string":
            return _unescape(value[1:-1])
        if value == "(":
            val = self.parse_concat()
            self.expect(")")
            return val
        if kind == "name":
            if value == "true":
                return True
            if value == "false":
                return False
            if value in _MATH_FNS:
                return _MATH_FNS[value]
            if value in _MATH_CALLS:
                self.expect("(")
                args = [self.parse_concat()]
                while (tok := self.peek()) and tok[1] == ",":
                    self.next()
                    args.append(self.parse_concat())
                self.expect(")")
                return _MATH_CALLS[value](*args)
            if value in self.env:
                return self.env[value]
            raise LuaConfigError(f"Unknown identifier in config: {value!r}")
        raise LuaConfigError(f"Unexpected token {value!r}")


def _lua_str(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


def _unescape(s: str) -> str:
    return s.replace("\\\"", "\"").replace("\\'", "'").replace("\\\\", "\\").replace("\\n", "\n")


def _strip_comments(text: str) -> str:
    # Block comments: --[[ ... ]] possibly followed by --
    text = re.sub(r"--\[\[.*?\]\](?:--)?", "", text, flags=re.DOTALL)
    # Line comments (avoid eating '--' inside strings: configs don't do that).
    lines = []
    for line in text.split("\n"):
        out, in_str, quote = [], False, ""
        i = 0
        while i < len(line):
            ch = line[i]
            if in_str:
                out.append(ch)
                if ch == "\\" and i + 1 < len(line):
                    out.append(line[i + 1])
                    i += 1
                elif ch == quote:
                    in_str = False
            else:
                if ch in "\"'":
                    in_str, quote = True, ch
                    out.append(ch)
                elif ch == "-" and i + 1 < len(line) and line[i + 1] == "-":
                    break
                else:
                    out.append(ch)
            i += 1
        lines.append("".join(out))
    return "\n".join(lines)


_INCLUDE_RE = re.compile(
    r"""^\s*(?:dofile\s*\(.*?['"](?P<dofile>[^'"]+?\.lua)['"].*?\)
           | dofile\s*\(.*?\.\.\s*['"](?P<dofile2>[^'"]+?\.lua)['"]\s*\)
           | require\s*\(\s*['"](?P<require>[^'"]+)['"]\s*\))\s*$""",
    re.VERBOSE,
)

_ASSIGN_RE = re.compile(r"^\s*(?:local\s+)?([A-Za-z_][A-Za-z0-9_]*)\s*=\s*(.+?)\s*$")


def _exec_lua_file(path: Path, env: Dict[str, Any], seen: set):
    path = path.resolve()
    if path in seen:
        return
    seen.add(path)
    if not path.exists():
        raise LuaConfigError(f"Config file not found: {path}")
    text = _strip_comments(path.read_text())
    for raw_line in text.split("\n"):
        line = raw_line.strip()
        if not line:
            continue
        if m := _INCLUDE_RE.match(line):
            if m.group("require"):
                # require("config.default_config") -> <repo>/config/default_config.lua
                rel = m.group("require").replace(".", "/") + ".lua"
                # Search upward from the config file's directory for the path.
                base = path.parent
                candidates = [base / rel, base.parent / rel,
                              base / Path(rel).name]
                target = next((c for c in candidates if c.exists()), None)
                if target is None:
                    raise LuaConfigError(f"Cannot resolve require({m.group('require')!r}) from {path}")
            else:
                fname = m.group("dofile") or m.group("dofile2")
                target = path.parent / Path(fname).name
            _exec_lua_file(target, env, seen)
            continue
        if m := _ASSIGN_RE.match(line):
            name, expr = m.group(1), m.group(2)
            env[name] = _ExprParser(_tokenize(expr), env).parse()
            continue
        raise LuaConfigError(f"Unsupported Lua statement in {path.name}: {line!r}")


@dataclass(frozen=True)
class Config:
    """Immutable view of a loaded Lua config.

    Attribute access returns the Lua value; ``.get_int`` mirrors the
    reference's CONFIG_INT truncation of Lua numbers to ints.
    """

    values: Dict[str, Any] = field(default_factory=dict)
    source: str = ""

    def __getattr__(self, name: str) -> Any:
        try:
            return self.values[name]
        except KeyError as e:
            raise AttributeError(f"Config key {name!r} not set (source={self.source})") from e

    def __contains__(self, name: str) -> bool:
        return name in self.values

    def get(self, name: str, default: Any = None) -> Any:
        return self.values.get(name, default)

    def get_int(self, name: str) -> int:
        return int(self.values[name])

    def replace(self, **overrides: Any) -> "Config":
        vals = dict(self.values)
        vals.update(overrides)
        return Config(vals, self.source)


def load_config(path) -> Config:
    """Load a Lua config file (with dofile/require includes) into a Config."""
    env: Dict[str, Any] = {}
    _exec_lua_file(Path(path), env, set())
    return Config(env, str(path))


# Keys a run config must define (the reference fails at first CONFIG_*
# access with an opaque Lua error; we validate up front, SURVEY.md §5
# failure-policy note).
REQUIRED_RUN_KEYS = (
    "bag_path", "pose_number", "odom_topic", "lidar_topic",
    "differential_odom", "translation_weight", "rotation_weight",
    "max_lidar_range", "rotation_change_for_lidar",
    "translation_change_for_lidar", "lidar_constraint_amount_min",
    "lidar_constraint_amount_max", "outlier_threshold",
    "hitl_line_width", "hitl_pose_point_threshold",
)


def validate_config(cfg: Config, require_bag: bool = True) -> None:
    """Fail fast with every missing key listed (not one at a time)."""
    missing = [k for k in REQUIRED_RUN_KEYS if k not in cfg]
    if not require_bag and "bag_path" in missing:
        missing.remove("bag_path")
    if missing:
        raise LuaConfigError(
            f"Config {cfg.source} is missing required keys: "
            f"{', '.join(missing)} (include default_config.lua)")


def load_config_text(text: str, base_dir: Optional[Path] = None) -> Config:
    """Parse config source text directly (for tests and synthetic setups)."""
    env: Dict[str, Any] = {}
    clean = _strip_comments(text)
    for raw_line in clean.split("\n"):
        line = raw_line.strip()
        if not line:
            continue
        if m := _INCLUDE_RE.match(line):
            if base_dir is None:
                raise LuaConfigError("Includes not supported without base_dir")
            fname = m.group("dofile") or m.group("dofile2") or (
                m.group("require").replace(".", "/") + ".lua")
            _exec_lua_file(base_dir / Path(fname).name, env, set())
            continue
        if m := _ASSIGN_RE.match(line):
            env[m.group(1)] = _ExprParser(_tokenize(m.group(2)), env).parse()
            continue
        raise LuaConfigError(f"Unsupported Lua statement: {line!r}")
    return Config(env, "<text>")
