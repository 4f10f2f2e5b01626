"""Dataflow graph: RON topology -> typed task graph.

Preserves the reference's graph-as-configuration surface
(``chalkydri.ron:1-157``: ``tasks`` with id/type/config/
resources, ``resources`` providers, ``cnx`` edges, ``logging``), but loads it
at startup instead of compiling it in (the reference must rebuild the binary
per graph, ``book/src/internals/index.md:5-7``).

The graph is validated (unique ids, known types, edges reference real tasks,
acyclic) and analyzed for *batchable camera chains* — linear source->...->sink
paths whose sink is batch-fusable (the AprilTags chains in the reference
graph). The scheduler collapses those chains into one leading batch axis on
device (SURVEY.md section 1, architectural signature).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from chalkydri_tpu_torch.io import ron


@dataclass
class TaskNode:
    id: str
    type: str
    config: dict = field(default_factory=dict)
    resources: dict = field(default_factory=dict)  # local name -> "bundle.key"
    logging_enabled: bool = True


@dataclass
class Edge:
    src: str
    dst: str
    msg: str = ""


@dataclass
class ResourceDecl:
    id: str
    provider: str
    config: dict = field(default_factory=dict)


@dataclass
class TaskGraph:
    tasks: list[TaskNode]
    edges: list[Edge]
    resources: list[ResourceDecl]
    enable_task_logging: bool = False

    # -- loading ------------------------------------------------------------

    @staticmethod
    def from_dict(d: dict) -> "TaskGraph":
        tasks = [
            TaskNode(
                id=t["id"],
                type=t["type"],
                config=t.get("config") or {},
                resources=t.get("resources") or {},
                logging_enabled=(t.get("logging") or {}).get("enabled", True),
            )
            for t in d.get("tasks", [])
        ]
        edges = [
            Edge(src=c["src"], dst=c["dst"], msg=c.get("msg", ""))
            for c in d.get("cnx", [])
        ]
        resources = [
            ResourceDecl(
                id=r["id"], provider=r["provider"], config=r.get("config") or {}
            )
            for r in (d.get("resources") or [])
        ]
        logging = d.get("logging") or {}
        g = TaskGraph(
            tasks=tasks,
            edges=edges,
            resources=resources,
            enable_task_logging=logging.get("enable_task_logging", False),
        )
        g.validate()
        return g

    @staticmethod
    def load(path: str) -> "TaskGraph":
        return TaskGraph.from_dict(ron.load(path))

    @staticmethod
    def loads(text: str) -> "TaskGraph":
        return TaskGraph.from_dict(ron.loads(text))

    def to_dict(self) -> dict:
        return {
            "tasks": [
                {
                    "id": t.id,
                    "type": t.type,
                    "config": {**t.config, "__force_map__": True} if t.config else {},
                    **({"resources": {**t.resources, "__force_map__": True}} if t.resources else {}),
                    "missions": None,
                }
                for t in self.tasks
            ],
            "resources": [
                {"id": r.id, "provider": r.provider} for r in self.resources
            ],
            "cnx": [
                {"src": e.src, "dst": e.dst, "msg": e.msg, "missions": None}
                for e in self.edges
            ],
            "logging": {"enable_task_logging": self.enable_task_logging},
        }

    def dumps(self) -> str:
        return ron.dumps(self.to_dict())

    # -- validation & analysis ----------------------------------------------

    def node(self, task_id: str) -> TaskNode:
        for t in self.tasks:
            if t.id == task_id:
                return t
        raise KeyError(task_id)

    def validate(self) -> None:
        ids = [t.id for t in self.tasks]
        if len(set(ids)) != len(ids):
            raise ValueError("duplicate task ids")
        idset = set(ids)
        for e in self.edges:
            if e.src not in idset or e.dst not in idset:
                raise ValueError(f"edge {e.src}->{e.dst} references unknown task")
        # acyclicity via Kahn
        order = self.topo_order()
        if len(order) != len(self.tasks):
            raise ValueError("graph has a cycle")

    def topo_order(self) -> list[str]:
        indeg = {t.id: 0 for t in self.tasks}
        adj: dict[str, list[str]] = {t.id: [] for t in self.tasks}
        for e in self.edges:
            indeg[e.dst] += 1
            adj[e.src].append(e.dst)
        ready = sorted([i for i, d in indeg.items() if d == 0])
        out = []
        while ready:
            n = ready.pop(0)
            out.append(n)
            for m in adj[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    ready.append(m)
            ready.sort()
        return out

    def successors(self, task_id: str) -> list[str]:
        return [e.dst for e in self.edges if e.src == task_id]

    def predecessors(self, task_id: str) -> list[str]:
        return [e.src for e in self.edges if e.dst == task_id]

    def chains(self) -> list[list[str]]:
        """Linear source->...->sink chains (the per-camera pipelines in the
        reference graph). A chain is a maximal path where every interior node
        has exactly one predecessor and one successor."""
        out = []
        sources = [t.id for t in self.tasks if not self.predecessors(t.id)]
        for s in sources:
            chain = [s]
            cur = s
            while True:
                succ = self.successors(cur)
                if len(succ) != 1:
                    break
                nxt = succ[0]
                if len(self.predecessors(nxt)) != 1:
                    break
                chain.append(nxt)
                cur = nxt
            out.append(chain)
        return out
