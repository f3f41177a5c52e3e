"""SQL persistence (users, predictions, statistics, model metrics).

The port's copy of mec_tpu/database (stdlib sqlite3 in WAL mode, or
PyMySQL when DATABASE_URL is mysql://); see database/db.py.
"""

from mec_tpu_torch.database.db import (
    Database,
    MySQLDatabase,
    User,
    Prediction,
    EmotionStatistic,
    ModelMetric,
    get_db,
    make_database,
    parse_db_url,
    init_db,
    hash_password,
    check_password,
)

__all__ = ['Database', 'MySQLDatabase', 'User', 'Prediction', 'EmotionStatistic',
           'ModelMetric', 'get_db', 'make_database', 'parse_db_url', 'init_db', 'hash_password',
           'check_password']
