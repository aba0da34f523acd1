"""Markov chain with enter/leave callbacks (cpp.algorithms MarkovChain,
used by the SoundEngine at include/soundengine.h:565-736, stepping at
soundengine.h:983-998).

Nodes carry a lambda invoked with ENTER_NODE when the chain moves into them
and LEAVE_NODE when it moves out. `step_normalized` always moves (transition
probabilities normalized over outgoing edges); `step` treats each probability
as an absolute chance and may stay put.

Host copy of cpp_audio_tpu/utils/markov.py.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class MarkovMove(enum.Enum):
    ENTER_NODE = "enter"
    LEAVE_NODE = "leave"


@dataclass
class MarkovNode:
    on_move: object  # callable (MarkovMove, me, other) -> None
    transitions: list = field(default_factory=list)  # (target_index, probability)


class MarkovChain:
    def __init__(self):
        self.nodes: list[MarkovNode] = []
        self.current: int | None = None

    def emplace(self, on_move) -> int:
        self.nodes.append(MarkovNode(on_move))
        return len(self.nodes) - 1

    def def_transition(self, a: int, b: int, probability: float) -> None:
        self.nodes[a].transitions.append((b, probability))

    def initialize(self, start: int) -> None:
        self.current = start

    def _move(self, dest: int, execute: bool) -> None:
        src = self.current
        if execute:
            self.nodes[src].on_move(MarkovMove.LEAVE_NODE, src, dest)
            self.nodes[dest].on_move(MarkovMove.ENTER_NODE, dest, src)
        self.current = dest

    def step_normalized(self, rand01: float, execute: bool = True) -> None:
        """Always move: pick among outgoing edges with normalized weights."""
        node = self.nodes[self.current]
        if not node.transitions:
            return
        total = sum(p for _, p in node.transitions)
        x = rand01 * total
        acc = 0.0
        for target, p in node.transitions:
            acc += p
            if x <= acc:
                self._move(target, execute)
                return
        self._move(node.transitions[-1][0], execute)

    def step(self, rand01: float, execute: bool = True) -> None:
        """Probabilistic move: each edge fires if rand falls in its band;
        otherwise stay."""
        node = self.nodes[self.current]
        acc = 0.0
        for target, p in node.transitions:
            acc += p
            if rand01 <= acc:
                self._move(target, execute)
                return
        # stay


def def_markov_transition(mc: MarkovChain, a: int, b: int, probability: float) -> None:
    mc.def_transition(a, b, probability)
