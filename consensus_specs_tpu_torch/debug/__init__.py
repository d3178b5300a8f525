"""Debug tooling: SSZ value <-> jsonable encoding and seeded random object
generation (ref: eth2spec/debug/{encode,decode,random_value}.py)."""
