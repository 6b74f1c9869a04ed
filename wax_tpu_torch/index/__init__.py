"""Dense and lexical index snapshots and their host builders."""
