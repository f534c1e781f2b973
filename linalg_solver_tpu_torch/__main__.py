"""``python -m linalg_solver_tpu_torch`` runs the CLI driver."""

from .cli import main

if __name__ == "__main__":
    main()
