from .artifact import DBArtifact, load_db
from .build import build_db, index_db
