"""Environment-variable substitution in path strings.

Re-implements the reference's ``modules/evsubst/evsubst.c`` semantics:
bash-style ``$VAR`` and ``${VAR}`` are replaced by the environment variable
value (empty string if undefined); text inside single quotes is protected
from substitution and the quotes are removed.
"""

from __future__ import annotations

import os
import re

_VAR_RE = re.compile(r"\$(\{([A-Za-z_][A-Za-z_0-9]*)\}|([A-Za-z_][A-Za-z_0-9]*))")


def _subst_plain(segment: str, env) -> str:
    def repl(m: re.Match) -> str:
        name = m.group(2) or m.group(3)
        return env.get(name, "")
    return _VAR_RE.sub(repl, segment)


def ev_subst(text: str, env=None) -> str:
    """Substitute ``$VAR``/``${VAR}`` outside single-quoted spans."""
    env = os.environ if env is None else env
    out = []
    in_quote = False
    buf = []
    for ch in text:
        if ch == "'":
            seg = "".join(buf)
            out.append(seg if in_quote else _subst_plain(seg, env))
            buf = []
            in_quote = not in_quote
        else:
            buf.append(ch)
    seg = "".join(buf)
    out.append(seg if in_quote else _subst_plain(seg, env))
    return "".join(out)
