"""Parameter-file ("Params") interpreter.

Re-implements the reference's four cooperating config engines
(SURVEY §5.6) in one module:

* ``pparse`` (``modules/pparser/pparser.c``): each non-special line is
  ``name  expression``; the expression is evaluated immediately with all
  previously defined names in scope and defines ``name``.
* ``cparser`` (``modules/cparser/cparser.c``): special command lines
  ``command option[=value] ...`` with quoting; commands are ``set``,
  ``icond``, ``grid``, ``mnemonic``, ``continue_if``, ``break`` and the
  ignored ``slice_*`` family (``intertrack.c:925-998``).
* the expression evaluator (:mod:`.expression`).
* ``evsubst`` ``$ENV`` substitution in path-valued options
  (``Params:26-33``).

Batch sweeps: loop variables ``i1..iN`` (plus ``loopIter``) are injected
into the evaluator before parsing; ``continue_if expr`` skips the iteration
when the expression is nonzero; ``mnemonic k: name1 name2 ...`` names the
values of loop variable ``i<k>`` for output-directory suffixes
(``intertrack.c:440-477, 840-880, 1332-1484``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

from ..core import tracing
from .expression import Evaluator, ExpressionError
from .evsubst import ev_subst


class ParamError(ValueError):
    pass


_SET_PATH_OPTIONS = {
    "out_file", "icond_file", "logfile", "debug_logfile",
    "snapshot_trigger", "pproc_script", "ball_positions_file",
}
_SET_VALUE_OPTIONS = _SET_PATH_OPTIONS | {"comment", "out_file_suffix"}
_SET_FLAG_OPTIONS = {
    "skip_icond", "continue_series", "pproc_nofail", "pproc_nowait",
    "pproc_waitfirst",
}
_SET_SKIP_OPTIONS = {
    "slice_outfile", "slice_input_dataset", "slice_stepping", "slice_colormap",
}
_SKIP_COMMANDS = {"slice_output", "slice_along", "slice_reverse_order"}


@dataclasses.dataclass
class ParamFile:
    """Result of interpreting a Params file for one (batch) iteration."""

    vars: Dict[str, float] = dataclasses.field(default_factory=dict)
    settings: Dict[str, str] = dataclasses.field(default_factory=dict)
    flags: Dict[str, bool] = dataclasses.field(default_factory=dict)
    icond_formulas: Dict[str, str] = dataclasses.field(default_factory=dict)
    grid_io_mode: str = "inner"      # 'inner' (default) or 'full' (intertrack.c:412)
    mnemonics: Dict[int, List[str]] = dataclasses.field(default_factory=dict)
    skipped: bool = False            # continue_if fired -> skip this iteration
    broke: bool = False              # 'break' command reached

    def get(self, name: str, default: Optional[float] = None) -> float:
        """The reference's ``evchk``/``evchkD``: fetch a numeric parameter."""
        if name in self.vars:
            return float(self.vars[name])
        if default is None:
            raise ParamError(f"required parameter {name!r} is not defined")
        return float(default)

    def get_int(self, name: str, default: Optional[int] = None) -> int:
        val = self.get(name, default)
        return int(val)

    def setting(self, name: str, default: str = "") -> str:
        return self.settings.get(name, default)

    def flag(self, name: str) -> bool:
        return self.flags.get(name, False)


def _strip_comment(line: str) -> str:
    """Remove a '#' comment that is not inside a quoted string."""
    out = []
    quote = None
    i = 0
    while i < len(line):
        ch = line[i]
        if quote:
            if ch == "\\" and i + 1 < len(line):
                out.append(line[i:i + 2])
                i += 2
                continue
            if ch == quote:
                quote = None
            out.append(ch)
        else:
            if ch == "#":
                break
            if ch in "\"'":
                quote = ch
            out.append(ch)
        i += 1
    return "".join(out)


def _split_words(text: str) -> List[str]:
    """Split on whitespace, keeping quoted spans (with quotes removed and
    escape sequences resolved) as single words, and treating a bare '=' as
    its own word so that ``opt = value`` and ``opt=value`` both parse."""
    words: List[str] = []
    buf: List[str] = []
    quote = None
    had_any = False

    def flush():
        nonlocal had_any
        if buf or had_any:
            words.append("".join(buf))
            buf.clear()
            had_any = False

    i = 0
    while i < len(text):
        ch = text[i]
        if quote:
            if ch == "\\" and i + 1 < len(text):
                buf.append(text[i + 1])
                i += 2
                continue
            if ch == quote:
                quote = None
                had_any = True
            else:
                buf.append(ch)
        elif ch in "\"'":
            quote = ch
        elif ch.isspace():
            flush()
        elif ch == "=":
            flush()
            words.append("=")
        else:
            buf.append(ch)
        i += 1
    flush()
    return words


def _parse_options(words: List[str]) -> List[Tuple[str, Optional[str]]]:
    """Turn ['a', '=', 'v', 'b', 'c', '=', 'w'] into [(a,v),(b,None),(c,w)]."""
    opts: List[Tuple[str, Optional[str]]] = []
    i = 0
    while i < len(words):
        name = words[i]
        if name == "=":
            raise ParamError("stray '=' in option list")
        if i + 1 < len(words) and words[i + 1] == "=":
            if i + 2 >= len(words):
                raise ParamError(f"option {name!r} missing value")
            opts.append((name, words[i + 2]))
            i += 3
        else:
            opts.append((name, None))
            i += 1
    return opts


_NAME_RE = re.compile(r"^[A-Za-z_][A-Za-z_0-9]*")


@tracing.span("pft.setup.params")
def parse_param_file(
    text: str,
    loop_vars: Optional[Dict[str, int]] = None,
    evaluator: Optional[Evaluator] = None,
    env=None,
) -> ParamFile:
    """Interpret a Params file's text.

    ``loop_vars`` maps ``i1..iN``/``loopIter`` to their current values for
    batch mode.  A fresh :class:`Evaluator` is used unless one is supplied.
    """
    ev = evaluator or Evaluator()
    for name, value in (loop_vars or {}).items():
        ev.define(name, float(value))

    result = ParamFile()

    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = _strip_comment(raw).strip()
        if not line:
            continue
        first = line.split(None, 1)[0]
        rest = line[len(first):].strip()

        try:
            if first == "set":
                for name, value in _parse_options(_split_words(rest)):
                    if name in _SET_FLAG_OPTIONS:
                        result.flags[name] = True
                    elif name in _SET_SKIP_OPTIONS:
                        pass  # consumed for tool compatibility (intertrack.c:942-946)
                    elif name in _SET_VALUE_OPTIONS:
                        if value is None:
                            raise ParamError(f"'set {name}' requires a value")
                        if name in _SET_PATH_OPTIONS:
                            value = ev_subst(value, env)
                        result.settings[name] = value
                    else:
                        raise ParamError(f"unknown 'set' option {name!r}")
            elif first == "icond":
                opts = _parse_options(_split_words(rest))
                for name, value in opts:
                    if value is None:
                        raise ParamError(f"'icond {name}' requires a formula")
                    result.icond_formulas[name] = value
            elif first == "grid":
                mode = rest.split(None, 1)[0] if rest else ""
                if mode not in ("full", "inner"):
                    raise ParamError(f"'grid' expects full|inner, got {mode!r}")
                result.grid_io_mode = mode
            elif first == "mnemonic":
                m = re.match(r"\s*(\d+)\s*:\s*(.*)$", rest)
                if not m:
                    raise ParamError("mnemonic: invalid loop control variable specification")
                result.mnemonics[int(m.group(1))] = m.group(2).split()
            elif first == "continue_if":
                value = float(ev.eval(rest))
                if value != 0:
                    result.skipped = True
                    result.broke = True
                    break
            elif first == "break":
                result.broke = True
                break
            elif first in _SKIP_COMMANDS:
                pass
            else:
                # plain 'name expression' line (pparser.c:92-108)
                if not _NAME_RE.match(first):
                    raise ParamError(f"invalid parameter name {first!r}")
                if not rest:
                    raise ParamError(f"parameter {first!r} has no expression")
                value = float(ev.eval(rest))
                ev.define(first, value)
                result.vars[first] = value
        except (ExpressionError, ParamError) as exc:
            raise ParamError(f"line {lineno}: {exc}") from exc

    return result


def loop_suffix(loop_values: List[int], ubounds: List[int],
                mnemonics: Dict[int, List[str]]) -> str:
    """Output-directory suffix ``_i1_i2...`` for a batch iteration, using
    mnemonic names when defined (intertrack.c:1440-1476)."""
    digits = max(len(str(u)) for u in ubounds) if ubounds else 1
    parts = []
    for q, val in enumerate(loop_values):
        names = mnemonics.get(q + 1, [])
        if len(names) >= val:
            parts.append("_" + names[val - 1])
        else:
            parts.append("_" + str(val).zfill(digits))
    return "".join(parts)


def batch_iterations(ubounds: List[int]):
    """Yield (loopIter, [i1..iN]) odometer sequences (innermost = last),
    matching intertrack.c:1377-1420."""
    if not ubounds:
        yield 1, []
        return
    idx = [1] * len(ubounds)
    idx[-1] = 0
    it = 0
    while True:
        q = len(ubounds) - 1
        while q >= 0 and idx[q] >= ubounds[q]:
            q -= 1
        if q < 0:
            return
        idx[q] += 1
        for k in range(q + 1, len(ubounds)):
            idx[k] = 1
        it += 1
        yield it, list(idx)
