"""``python -m sheeprl_tpu_torch [overrides...]`` — train (``cli.run``).

The first argument may name another entry point, as the JAX package's
``__main__`` takes it: ``eval`` / ``--eval``, ``serve``,
``register-model`` / ``--register-model`` and ``agents`` / ``--agents``;
``supervise`` runs the rest under the self-healing supervisor
(:mod:`sheeprl_tpu_torch.supervisor`), and ``lint`` runs graftlint's
registry rules over the port (:mod:`sheeprl_tpu_torch.analysis`).
"""

import sys

from sheeprl_tpu_torch.cli import available_agents, evaluation, registration, run, serve

if __name__ == "__main__":
    argv = sys.argv[1:]
    cmd = argv[0].lstrip("-") if argv else ""
    if cmd == "eval":
        evaluation(argv[1:])
    elif cmd == "serve":
        serve(argv[1:])
    elif cmd == "register-model":
        registration(argv[1:])
    elif cmd == "agents":
        available_agents()
    elif cmd == "lint":
        from sheeprl_tpu_torch.analysis.__main__ import main as lint

        sys.exit(lint(argv[1:]))
    elif cmd == "supervise":
        from sheeprl_tpu_torch.supervisor import main

        main(argv[1:])
    else:
        run(argv)
