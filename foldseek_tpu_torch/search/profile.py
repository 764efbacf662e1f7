"""Profile DBs (result2profile output). Only their detection is here: profile
search itself is not ported yet (ROADMAP queue 1, item 12)."""
from __future__ import annotations

import json
import os


def is_profile_db(path: str) -> bool:
    m = os.path.join(path, "manifest.json")
    if not os.path.isfile(m):
        return False
    try:
        return json.load(open(m)).get("kind") == "profile"
    except Exception:
        return False
