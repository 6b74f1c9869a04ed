"""Agent and operator surfaces: the MCP server, the CLI, repo memory and the crash harness."""
