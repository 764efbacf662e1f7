"""Target and query databases of the port.

DB storage, createdb and the synthetic scale DBs are host code with the same
file formats as `foldseek_tpu`'s, so both packages read and write the same
DB directories; `panels` holds what a target DB keeps on the device.
"""
from ..ingest.createdb import create_db
from .storage import StructDB, is_db, load_db
from .synth import synth_db

__all__ = ["StructDB", "create_db", "is_db", "load_db", "synth_db"]
