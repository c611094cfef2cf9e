"""`python -m owl_path_tracer` == the reference's ./path_tracer run
(Main.cpp:13-31): read assets/settings.json, run the configured sweep."""
from .utils.cli import main

main()
