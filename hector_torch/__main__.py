"""``python -m hector_torch``: the port's command line (cli.py)."""

from .cli import main

if __name__ == '__main__':
    main()
