"""GUPPI / rawspec file-name and directory-name parsing.

Counterpart of ``blit/naming.py``, with the same regexes and results:
the reference's ``parseguppiname`` / ``parserawspecname`` verbose
regexes (``src/gbtworkerfunctions.jl:35-61``) and its session / player
directory regexes (``src/gbt.jl:50-52``), with ``blit``'s two fixes:

- the player regex is ``^BLP(?P<band>[0-7])(?P<bank>[0-7])$`` (the
  reference's ``[?<band>0-7]`` is a character class, so it admits
  ``BLPd3``);
- every dot of a literal suffix (``.rawspec.``, ``.h5``) is escaped.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

# A session: GBT project id + session id, e.g. "AGBT22B_999_01".
SESSION_RE = re.compile(r"[AT]GBT[12][0-9][AB]_\d+_\d+")

# A player directory, the recording node "BLP<band><bank>".
PLAYER_RE = re.compile(r"^BLP(?P<band>[0-7])(?P<bank>[0-7])$")

# The inventory's default file pattern: the low-resolution product.
DEFAULT_FILE_RE = re.compile(r"0002\.h5$")

# The /BLP<band><bank>/ path component, searched anywhere in the path
# (the reference's single regex allows at most one directory between it
# and the file).
PLAYER_COMPONENT_RE = re.compile(r"/BLP(?P<band>[0-7])(?P<bank>[0-7])(?=/)")

# A GUPPI-convention basename, e.g.
#   blc42_guppi_59897_21221_HD_84406_0011.rawspec.0002.h5
# searched (unanchored) like Julia's `match`; the host prefix and the
# numeric field between smjd and the source name are optional.
GUPPI_BASE_RE = re.compile(
    r"""
    (?:(?P<host>blc..)_)?
    guppi_
    (?P<imjd>\d+)_
    (?P<smjd>\d+)_
    (?:\d+_)?
    (?P<src>.*)_
    (?P<scan>\d{4})
    """,
    re.VERBOSE,
)

# The stricter form that also captures the rawspec product number and
# requires a ".rawspec.NNNN.h5|fil" suffix.
RAWSPEC_BASE_RE = re.compile(
    GUPPI_BASE_RE.pattern
    + r"""
    \.rawspec\.
    (?P<product>\d{4})
    \.(?:h5|fil)$
    """,
    re.VERBOSE,
)


@dataclass(frozen=True)
class GuppiName:
    """Parsed components of a GUPPI-convention path.  ``band``/``bank``/
    ``host`` are None without the ``/BLP<band><bank>/`` component or the
    ``blc??_`` prefix; ``product`` is set by :func:`parse_rawspec_name`
    only."""

    imjd: int
    smjd: int
    src: str
    scan: str
    band: Optional[int] = None
    bank: Optional[int] = None
    host: Optional[str] = None
    product: Optional[str] = None


def _parse(name: str, base_re: re.Pattern, require_player: bool) -> Optional[GuppiName]:
    base = name.rsplit("/", 1)[-1]
    m = base_re.search(base)
    if m is None:
        return None
    # The rightmost /BLPbb/ component: the player directory sits closest
    # to the file, so a BLP-like component higher up must not shadow it.
    pm = None
    for pm in PLAYER_COMPONENT_RE.finditer(name):
        pass
    if require_player and pm is None:
        return None
    g = m.groupdict()
    return GuppiName(
        imjd=int(g["imjd"]),
        smjd=int(g["smjd"]),
        src=g["src"],
        scan=g["scan"],
        band=int(pm.group("band")) if pm else None,
        bank=int(pm.group("bank")) if pm else None,
        host=g.get("host"),
        product=g.get("product"),
    )


def parse_guppi_name(name: str) -> Optional[GuppiName]:
    """Parse a GUPPI-convention path (``*.NNNN.raw`` recordings and
    ``*.rawspec.NNNN.{h5,fil}`` products); None when it does not match.
    ``band``/``bank`` come from a ``/BLP<band><bank>/`` component at any
    depth."""
    return _parse(name, GUPPI_BASE_RE, require_player=False)


def parse_rawspec_name(name: str) -> Optional[GuppiName]:
    """Parse a rawspec product path; requires the ``/BLPbb/`` component
    and the ``.rawspec.NNNN.{h5,fil}`` suffix."""
    return _parse(name, RAWSPEC_BASE_RE, require_player=True)


def player_name(band: int, bank: int) -> str:
    """The recording node's name ``BLP<band><bank>``."""
    if not (0 <= band <= 7 and 0 <= bank <= 7):
        raise ValueError(f"band and bank must be in 0..7, got {band},{bank}")
    return f"BLP{band}{bank}"
