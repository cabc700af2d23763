"""Interactive Explorer: an HTTP service + browser UI for walking the state
graph of a lazily-expanded (on-demand) check (ref: src/checker/explorer.rs,
ui/). Start it with `model.checker().serve("localhost:3000")`.
"""

from .server import ExplorerServer, serve, states_view, status_view

__all__ = ["ExplorerServer", "serve", "states_view", "status_view"]
