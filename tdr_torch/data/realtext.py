# Copied from tdr/data/realtext.py unchanged.
"""Checked-in real-text multilingual evaluation set (VERDICT r4 #8).

Every recall number in rounds 1-4 was computed on synthetic corpora; the
reference's headline (recall@10 0.77599) is on real multilingual text
(/root/reference/README.md:7-9), which is not available in this
environment.  This module narrows that gap with a small NON-synthetic
eval: natural-language encyclopedic paragraphs in the reference's seven
languages, written for this fixture (original text, not copied from any
corpus), with keyword queries targeting exactly one document each.

20 documents and 10 queries per language (140 docs / 70 queries).  Scale
is NOT the point — the synthetic benches cover scale; this set exercises
what synthetic text cannot: real morphology (German compounds, Arabic
clitics, Korean particles), real stopword density, diacritics, and real
query-document vocabulary mismatch.  The bench's ``real_text`` section
(TDR_BENCH_REALTEXT) reports recall@10 over it through the standard
build + router path, per language.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# {lang: [(doc_id, text), ...]}
REAL_DOCS: Dict[str, List[Tuple[str, str]]] = {
    "en": [
        ("en-d00", "Honeybees collect nectar from flowering plants and, in "
         "doing so, transfer pollen between blossoms. Many fruit and seed "
         "crops depend on this pollination, and beekeepers move hives "
         "between orchards during the flowering season."),
        ("en-d01", "Alpine glaciers have been retreating since the middle "
         "of the nineteenth century. Comparing old photographs with modern "
         "surveys shows that many ice tongues have lost more than half of "
         "their length, and meltwater now feeds new mountain lakes."),
        ("en-d02", "The industrial revolution began in the textile mills of "
         "northern England, where water wheels and later steam engines "
         "drove spinning machines. Cloth that had been woven by hand in "
         "cottages was suddenly produced in enormous factories."),
        ("en-d03", "Photosynthesis takes place in the chloroplasts of green "
         "leaves, where sunlight splits water and fixes carbon dioxide "
         "into sugar. The oxygen released as a by-product sustains almost "
         "all animal life on the planet."),
        ("en-d04", "Stock markets react quickly to central bank decisions. "
         "When an unexpected interest rate increase is announced, bond "
         "yields rise, borrowing becomes more expensive, and share prices "
         "of indebted companies usually fall within minutes."),
        ("en-d05", "A quantum computer stores information in qubits, which "
         "can occupy superpositions of zero and one. Algorithms that "
         "exploit interference between these states can factor numbers "
         "and simulate molecules far faster than classical machines."),
        ("en-d06", "Roman engineers built aqueducts that carried fresh "
         "water across valleys on arched stone bridges. The gentle, "
         "carefully surveyed gradient kept the water flowing for dozens "
         "of kilometres from mountain springs to public fountains."),
        ("en-d07", "Coral reefs bleach when unusually warm seawater forces "
         "the polyps to expel their symbiotic algae. Without the algae "
         "the coral loses both its colour and its main source of food, "
         "and prolonged heat can kill entire reef systems."),
        ("en-d08", "The movable-type printing press spread rapidly across "
         "Europe in the late fifteenth century. Books that once took "
         "months to copy by hand could be printed in days, and literacy "
         "expanded with the falling price of paper and print."),
        ("en-d09", "Antibiotics lose their effectiveness when bacteria "
         "evolve resistance. Overuse in medicine and livestock farming "
         "accelerates this process, which is why physicians are urged to "
         "prescribe narrow-spectrum drugs only when necessary."),
        ("en-d10", "Jazz grew out of ragtime and blues in the dance halls "
         "of New Orleans, where brass bands improvised over syncopated "
         "rhythms. Recordings carried the new music up the Mississippi "
         "to Chicago and then to the rest of the world."),
        ("en-d11", "Volcanic ash clouds are a serious hazard for aviation "
         "because the fine glassy particles melt inside jet engines. "
         "After a large eruption, flights are rerouted around the plume "
         "and airports downwind may close for days."),
        ("en-d12", "Chess originated in northern India as a war game "
         "played on an eight by eight board. Traders carried it through "
         "Persia into Europe, where the modern moves of the queen and "
         "bishop were settled during the Renaissance."),
        ("en-d13", "Olive oil is pressed from the fruit of a tree that "
         "thrives in dry Mediterranean summers. The first cold pressing "
         "yields the finest grade, while later extractions under heat "
         "produce oil destined for refining."),
        ("en-d14", "High-speed trains run on dedicated tracks with gentle "
         "curves and no level crossings. Electric traction and careful "
         "aerodynamic design allow scheduled services at three hundred "
         "kilometres per hour between major cities."),
        ("en-d15", "During deep sleep the brain replays the day's "
         "experiences and consolidates them into long-term memory. "
         "Students who sleep well after studying recall word lists "
         "better than those who stay awake through the night."),
        ("en-d16", "Lighthouses warned sailors away from rocks long before "
         "satellite navigation existed. A rotating lens concentrated the "
         "flame of an oil lamp into a beam, and each station flashed a "
         "distinctive pattern that ships could identify."),
        ("en-d17", "Desalination plants turn seawater into drinking water "
         "by forcing it through reverse-osmosis membranes under high "
         "pressure. The process consumes considerable electricity, so "
         "arid coastal cities often pair the plants with solar farms."),
        ("en-d18", "Comets are ancient bodies of ice and dust that swing "
         "around the sun on stretched elliptical orbits. As one nears "
         "perihelion, sunlight vaporises its surface and the escaping "
         "gas forms the bright tail that points away from the sun."),
        ("en-d19", "A wind turbine converts the motion of air into "
         "electricity through a gearbox and generator mounted high on a "
         "tower. Offshore farms catch steadier winds than sites on "
         "land, at the price of harder maintenance at sea."),
    ],
    "fr": [
        ("fr-d00", "Les abeilles récoltent le nectar des plantes à fleurs "
         "et transportent ainsi le pollen d'une fleur à l'autre. De "
         "nombreuses cultures fruitières dépendent de cette pollinisation, "
         "et les apiculteurs déplacent leurs ruches entre les vergers au "
         "printemps."),
        ("fr-d01", "Les glaciers des Alpes reculent depuis le milieu du "
         "dix-neuvième siècle. La comparaison d'anciennes photographies "
         "avec les relevés modernes montre que plusieurs langues de glace "
         "ont perdu plus de la moitié de leur longueur."),
        ("fr-d02", "La révolution industrielle commença dans les filatures "
         "de coton, où la roue hydraulique puis la machine à vapeur "
         "entraînaient les métiers. Le tissu autrefois fabriqué à la main "
         "sortit soudain d'immenses usines."),
        ("fr-d03", "La photosynthèse se déroule dans les chloroplastes des "
         "feuilles vertes, où la lumière du soleil fixe le dioxyde de "
         "carbone en sucre. L'oxygène libéré entretient presque toute la "
         "vie animale de la planète."),
        ("fr-d04", "Les marchés boursiers réagissent vite aux décisions "
         "des banques centrales. Quand une hausse inattendue des taux "
         "d'intérêt est annoncée, le crédit devient plus cher et les "
         "actions des entreprises endettées chutent en quelques minutes."),
        ("fr-d05", "Un ordinateur quantique stocke l'information dans des "
         "qubits capables de superposer le zéro et le un. Les algorithmes "
         "qui exploitent ces états factorisent les nombres bien plus vite "
         "que les machines classiques."),
        ("fr-d06", "Les ingénieurs romains construisirent des aqueducs qui "
         "franchissaient les vallées sur des ponts de pierre en arches. "
         "Une pente douce et soigneusement mesurée menait l'eau des "
         "sources de montagne jusqu'aux fontaines publiques."),
        ("fr-d07", "Les récifs coralliens blanchissent lorsque une eau de "
         "mer trop chaude force les polypes à expulser leurs algues "
         "symbiotiques. Sans ces algues, le corail perd sa couleur et sa "
         "principale source de nourriture."),
        ("fr-d08", "L'imprimerie à caractères mobiles se répandit dans "
         "toute l'Europe à la fin du quinzième siècle. Les livres jadis "
         "copiés à la main pendant des mois furent imprimés en quelques "
         "jours et la lecture se démocratisa."),
        ("fr-d09", "Les antibiotiques perdent leur efficacité quand les "
         "bactéries développent des résistances. L'usage excessif en "
         "médecine et dans l'élevage accélère ce phénomène, d'où la "
         "prudence demandée aux médecins."),
        ("fr-d10", "Le jazz naquit du ragtime et du blues dans les salles "
         "de danse de La Nouvelle-Orléans, où les fanfares improvisaient "
         "sur des rythmes syncopés. Les disques portèrent cette musique "
         "jusqu'à Chicago puis au monde entier."),
        ("fr-d11", "Les nuages de cendres volcaniques menacent l'aviation "
         "car les fines particules de verre fondent dans les réacteurs. "
         "Après une grande éruption, les vols contournent le panache et "
         "les aéroports sous le vent ferment parfois plusieurs jours."),
        ("fr-d12", "Les échecs virent le jour dans le nord de l'Inde comme "
         "jeu de guerre sur un plateau de soixante-quatre cases. Les "
         "marchands les portèrent à travers la Perse vers l'Europe, où "
         "les règles modernes furent fixées à la Renaissance."),
        ("fr-d13", "L'huile d'olive est pressée à partir du fruit d'un "
         "arbre qui prospère sous les étés secs de la Méditerranée. La "
         "première pression à froid donne la meilleure qualité, réservée "
         "à la table."),
        ("fr-d14", "Les trains à grande vitesse circulent sur des voies "
         "dédiées aux courbes douces, sans passage à niveau. La traction "
         "électrique permet des liaisons régulières à trois cents "
         "kilomètres par heure entre les grandes villes."),
        ("fr-d15", "Pendant le sommeil profond, le cerveau rejoue les "
         "expériences de la journée et les consolide en mémoire durable. "
         "Les étudiants qui dorment bien après avoir révisé retiennent "
         "mieux leurs listes de mots."),
        ("fr-d16", "Les phares avertissaient les marins des récifs bien "
         "avant la navigation par satellite. Une lentille tournante "
         "concentrait la flamme d'une lampe à huile en un faisceau, et "
         "chaque station émettait un signal distinctif."),
        ("fr-d17", "Les usines de dessalement transforment l'eau de mer "
         "en eau potable en la poussant à haute pression à travers des "
         "membranes d'osmose inverse. Le procédé consomme beaucoup "
         "d'électricité, souvent fournie par des fermes solaires."),
        ("fr-d18", "Les comètes sont d'anciens corps de glace et de "
         "poussière qui contournent le soleil sur des orbites très "
         "allongées. Près du périhélie, le gaz qui s'échappe forme la "
         "queue brillante pointée à l'opposé du soleil."),
        ("fr-d19", "Une éolienne convertit le mouvement de l'air en "
         "électricité grâce à un multiplicateur et à une génératrice "
         "perchés en haut d'un mât. Les parcs en mer profitent de vents "
         "plus réguliers que les sites terrestres."),
    ],
    "de": [
        ("de-d00", "Honigbienen sammeln Nektar von Blütenpflanzen und "
         "übertragen dabei Pollen von Blüte zu Blüte. Viele Obstsorten "
         "sind auf diese Bestäubung angewiesen, weshalb Imker ihre "
         "Bienenstöcke zur Blütezeit zwischen den Obstgärten umstellen."),
        ("de-d01", "Die Alpengletscher ziehen sich seit der Mitte des "
         "neunzehnten Jahrhunderts zurück. Der Vergleich alter "
         "Fotografien mit modernen Vermessungen zeigt, dass viele "
         "Gletscherzungen über die Hälfte ihrer Länge verloren haben."),
        ("de-d02", "Die industrielle Revolution begann in den "
         "Baumwollspinnereien, wo Wasserräder und später Dampfmaschinen "
         "die Spinnmaschinen antrieben. Stoff, der einst in Heimarbeit "
         "gewebt wurde, entstand plötzlich in riesigen Fabriken."),
        ("de-d03", "Die Photosynthese findet in den Chloroplasten grüner "
         "Blätter statt, wo Sonnenlicht Wasser spaltet und Kohlendioxid "
         "zu Zucker bindet. Der freigesetzte Sauerstoff erhält nahezu "
         "alles tierische Leben."),
        ("de-d04", "Aktienmärkte reagieren schnell auf Entscheidungen der "
         "Zentralbanken. Wird eine unerwartete Zinserhöhung verkündet, "
         "verteuern sich Kredite, und die Kurse verschuldeter "
         "Unternehmen fallen binnen Minuten."),
        ("de-d05", "Ein Quantencomputer speichert Information in Qubits, "
         "die Überlagerungen von Null und Eins einnehmen können. "
         "Algorithmen, die diese Zustände ausnutzen, zerlegen Zahlen "
         "weit schneller als klassische Rechner."),
        ("de-d06", "Römische Ingenieure bauten Aquädukte, die frisches "
         "Wasser auf steinernen Bogenbrücken über Täler führten. Das "
         "sorgfältig vermessene Gefälle hielt das Wasser über Dutzende "
         "Kilometer von den Bergquellen bis zu den Brunnen in Bewegung."),
        ("de-d07", "Korallenriffe bleichen aus, wenn ungewöhnlich warmes "
         "Meerwasser die Polypen zwingt, ihre symbiotischen Algen "
         "abzustoßen. Ohne die Algen verliert die Koralle Farbe und "
         "Nahrungsquelle zugleich."),
        ("de-d08", "Der Buchdruck mit beweglichen Lettern verbreitete "
         "sich im späten fünfzehnten Jahrhundert rasch über Europa. "
         "Bücher, deren Abschrift Monate gedauert hatte, wurden in "
         "Tagen gedruckt, und das Lesen wurde erschwinglich."),
        ("de-d09", "Antibiotika verlieren ihre Wirkung, wenn Bakterien "
         "Resistenzen entwickeln. Übermäßiger Einsatz in Medizin und "
         "Tierhaltung beschleunigt diesen Vorgang, weshalb Ärzte zur "
         "zurückhaltenden Verschreibung angehalten werden."),
        ("de-d10", "Der Jazz entstand aus Ragtime und Blues in den "
         "Tanzsälen von New Orleans, wo Blaskapellen über synkopierte "
         "Rhythmen improvisierten. Schallplatten trugen die neue Musik "
         "den Mississippi hinauf nach Chicago."),
        ("de-d11", "Vulkanische Aschewolken sind eine ernste Gefahr für "
         "die Luftfahrt, weil die feinen Glaspartikel in den Triebwerken "
         "schmelzen. Nach einem großen Ausbruch werden Flüge um die "
         "Wolke herumgeleitet."),
        ("de-d12", "Das Schachspiel stammt aus Nordindien, wo es als "
         "Kriegsspiel auf einem Brett mit vierundsechzig Feldern "
         "gespielt wurde. Händler brachten es über Persien nach Europa, "
         "wo die modernen Zugregeln entstanden."),
        ("de-d13", "Olivenöl wird aus den Früchten eines Baumes gepresst, "
         "der trockene Mittelmeersommer bevorzugt. Die erste kalte "
         "Pressung liefert die feinste Güteklasse, spätere Extraktionen "
         "unter Wärme gehen in die Raffinerie."),
        ("de-d14", "Hochgeschwindigkeitszüge fahren auf eigenen Strecken "
         "mit sanften Kurven und ohne Bahnübergänge. Elektrischer "
         "Antrieb und aerodynamische Form erlauben fahrplanmäßige "
         "Fahrten mit dreihundert Kilometern pro Stunde."),
        ("de-d15", "Im Tiefschlaf wiederholt das Gehirn die Erlebnisse "
         "des Tages und verfestigt sie im Langzeitgedächtnis. Wer nach "
         "dem Lernen gut schläft, erinnert Wortlisten besser als nach "
         "einer durchwachten Nacht."),
        ("de-d16", "Leuchttürme warnten Seeleute vor Felsen, lange bevor "
         "es Satellitennavigation gab. Eine rotierende Linse bündelte "
         "die Flamme einer Öllampe zu einem Strahl, und jede Station "
         "blinkte in einem eigenen Rhythmus."),
        ("de-d17", "Entsalzungsanlagen machen aus Meerwasser Trinkwasser, "
         "indem sie es unter hohem Druck durch Umkehrosmose-Membranen "
         "pressen. Das Verfahren verbraucht viel Strom, weshalb trockene "
         "Küstenstädte es oft mit Solarparks koppeln."),
        ("de-d18", "Kometen sind uralte Körper aus Eis und Staub, die auf "
         "gestreckten Ellipsenbahnen um die Sonne ziehen. Nahe dem "
         "sonnennächsten Punkt verdampft ihre Oberfläche, und das Gas "
         "bildet den hellen Schweif."),
        ("de-d19", "Eine Windkraftanlage wandelt die Bewegung der Luft "
         "über Getriebe und Generator hoch auf dem Turm in Strom um. "
         "Anlagen auf See nutzen stetigere Winde als Standorte an Land, "
         "sind aber schwerer zu warten."),
    ],
    "es": [
        ("es-d00", "Las abejas recogen néctar de las plantas con flores y "
         "al hacerlo trasladan el polen de una flor a otra. Muchos "
         "cultivos de fruta dependen de esta polinización, y los "
         "apicultores mueven sus colmenas entre huertos en primavera."),
        ("es-d01", "Los glaciares alpinos retroceden desde mediados del "
         "siglo diecinueve. Al comparar fotografías antiguas con "
         "mediciones modernas se ve que muchas lenguas de hielo han "
         "perdido más de la mitad de su longitud."),
        ("es-d02", "La revolución industrial comenzó en las hilanderías "
         "de algodón, donde ruedas hidráulicas y luego máquinas de vapor "
         "movían los telares. La tela que se tejía a mano pasó a salir "
         "de fábricas enormes."),
        ("es-d03", "La fotosíntesis ocurre en los cloroplastos de las "
         "hojas verdes, donde la luz solar fija el dióxido de carbono en "
         "azúcar. El oxígeno liberado sostiene casi toda la vida animal "
         "del planeta."),
        ("es-d04", "Las bolsas reaccionan con rapidez a las decisiones de "
         "los bancos centrales. Cuando se anuncia una subida inesperada "
         "de los tipos de interés, el crédito se encarece y las acciones "
         "de las empresas endeudadas caen en minutos."),
        ("es-d05", "Un ordenador cuántico guarda la información en qubits "
         "que pueden superponer el cero y el uno. Los algoritmos que "
         "aprovechan esos estados factorizan números mucho más rápido "
         "que las máquinas clásicas."),
        ("es-d06", "Los ingenieros romanos construyeron acueductos que "
         "cruzaban los valles sobre puentes de piedra con arcos. Una "
         "pendiente suave y bien medida llevaba el agua desde los "
         "manantiales de montaña hasta las fuentes públicas."),
        ("es-d07", "Los arrecifes de coral se blanquean cuando un agua "
         "marina demasiado cálida obliga a los pólipos a expulsar sus "
         "algas simbióticas. Sin las algas el coral pierde su color y su "
         "principal alimento."),
        ("es-d08", "La imprenta de tipos móviles se extendió por Europa a "
         "finales del siglo quince. Los libros que antes se copiaban a "
         "mano durante meses se imprimieron en días y la lectura se "
         "abarató."),
        ("es-d09", "Los antibióticos pierden eficacia cuando las "
         "bacterias desarrollan resistencia. El uso excesivo en medicina "
         "y ganadería acelera el proceso, por lo que se pide a los "
         "médicos recetar con prudencia."),
        ("es-d10", "El jazz nació del ragtime y del blues en los salones "
         "de baile de Nueva Orleans, donde las bandas de metales "
         "improvisaban sobre ritmos sincopados. Los discos llevaron esa "
         "música hasta Chicago y el resto del mundo."),
        ("es-d11", "Las nubes de ceniza volcánica son un peligro grave "
         "para la aviación porque las finas partículas de vidrio se "
         "funden dentro de los motores. Tras una gran erupción los "
         "vuelos rodean la columna de ceniza."),
        ("es-d12", "El ajedrez surgió en el norte de la India como juego "
         "de guerra sobre un tablero de sesenta y cuatro casillas. Los "
         "mercaderes lo llevaron por Persia hasta Europa, donde se "
         "fijaron las reglas modernas."),
        ("es-d13", "El aceite de oliva se prensa del fruto de un árbol "
         "que prospera en los veranos secos del Mediterráneo. La primera "
         "prensada en frío da la calidad más fina, reservada para la "
         "mesa."),
        ("es-d14", "Los trenes de alta velocidad circulan por vías "
         "propias con curvas suaves y sin pasos a nivel. La tracción "
         "eléctrica permite servicios regulares a trescientos "
         "kilómetros por hora entre grandes ciudades."),
        ("es-d15", "Durante el sueño profundo el cerebro repasa las "
         "experiencias del día y las consolida en la memoria duradera. "
         "Los estudiantes que duermen bien tras estudiar recuerdan mejor "
         "las listas de palabras."),
        ("es-d16", "Los faros avisaban a los marineros de las rocas mucho "
         "antes de la navegación por satélite. Una lente giratoria "
         "concentraba la llama de una lámpara de aceite en un haz con un "
         "destello característico."),
        ("es-d17", "Las plantas desalinizadoras convierten el agua de mar "
         "en agua potable forzándola a alta presión a través de "
         "membranas de ósmosis inversa. El proceso consume mucha "
         "electricidad, a menudo de origen solar."),
        ("es-d18", "Los cometas son cuerpos antiguos de hielo y polvo que "
         "giran alrededor del sol en órbitas muy alargadas. Cerca del "
         "perihelio el gas que escapa forma la cola brillante que apunta "
         "en dirección contraria al sol."),
        ("es-d19", "Un aerogenerador convierte el movimiento del aire en "
         "electricidad mediante una multiplicadora y un generador en lo "
         "alto de una torre. Los parques marinos reciben vientos más "
         "constantes que los terrestres."),
    ],
    "it": [
        ("it-d00", "Le api raccolgono il nettare dalle piante in fiore e "
         "così facendo trasportano il polline da un fiore all'altro. "
         "Molte colture da frutto dipendono da questa impollinazione e "
         "gli apicoltori spostano le arnie tra i frutteti in primavera."),
        ("it-d01", "I ghiacciai alpini arretrano dalla metà "
         "dell'Ottocento. Il confronto tra vecchie fotografie e rilievi "
         "moderni mostra che molte lingue di ghiaccio hanno perso oltre "
         "la metà della loro lunghezza."),
        ("it-d02", "La rivoluzione industriale cominciò nelle filande di "
         "cotone, dove ruote idrauliche e poi macchine a vapore "
         "muovevano i telai. Il tessuto un tempo fatto a mano uscì "
         "all'improvviso da fabbriche enormi."),
        ("it-d03", "La fotosintesi avviene nei cloroplasti delle foglie "
         "verdi, dove la luce del sole fissa l'anidride carbonica in "
         "zucchero. L'ossigeno liberato sostiene quasi tutta la vita "
         "animale del pianeta."),
        ("it-d04", "Le borse reagiscono in fretta alle decisioni delle "
         "banche centrali. Quando viene annunciato un rialzo inatteso "
         "dei tassi di interesse, il credito costa di più e i titoli "
         "delle imprese indebitate scendono in pochi minuti."),
        ("it-d05", "Un computer quantistico conserva l'informazione in "
         "qubit capaci di sovrapporre lo zero e l'uno. Gli algoritmi che "
         "sfruttano questi stati fattorizzano i numeri molto più in "
         "fretta delle macchine classiche."),
        ("it-d06", "Gli ingegneri romani costruirono acquedotti che "
         "attraversavano le valli su ponti di pietra ad arcate. Una "
         "pendenza dolce e ben misurata portava l'acqua dalle sorgenti "
         "di montagna alle fontane pubbliche."),
        ("it-d07", "Le barriere coralline sbiancano quando un'acqua "
         "marina troppo calda costringe i polipi a espellere le alghe "
         "simbionti. Senza le alghe il corallo perde il colore e la sua "
         "principale fonte di cibo."),
        ("it-d08", "La stampa a caratteri mobili si diffuse rapidamente "
         "in Europa alla fine del Quattrocento. I libri che prima "
         "richiedevano mesi di copiatura a mano furono stampati in "
         "pochi giorni e la lettura divenne accessibile."),
        ("it-d09", "Gli antibiotici perdono efficacia quando i batteri "
         "sviluppano resistenza. L'uso eccessivo in medicina e negli "
         "allevamenti accelera il fenomeno, perciò ai medici si chiede "
         "prudenza nelle prescrizioni."),
        ("it-d10", "Il jazz nacque dal ragtime e dal blues nelle sale da "
         "ballo di New Orleans, dove le bande di ottoni improvvisavano "
         "su ritmi sincopati. I dischi portarono la nuova musica fino a "
         "Chicago e poi nel mondo."),
        ("it-d11", "Le nubi di cenere vulcanica sono un pericolo serio "
         "per l'aviazione perché le sottili particelle di vetro fondono "
         "dentro i motori a reazione. Dopo una grande eruzione i voli "
         "aggirano il pennacchio."),
        ("it-d12", "Gli scacchi nacquero nell'India settentrionale come "
         "gioco di guerra su una scacchiera di sessantaquattro case. I "
         "mercanti li portarono attraverso la Persia in Europa, dove si "
         "fissarono le mosse moderne."),
        ("it-d13", "L'olio d'oliva si spreme dal frutto di un albero che "
         "prospera nelle estati secche del Mediterraneo. La prima "
         "spremitura a freddo dà la qualità più fine, destinata alla "
         "tavola."),
        ("it-d14", "I treni ad alta velocità corrono su linee dedicate "
         "con curve dolci e senza passaggi a livello. La trazione "
         "elettrica consente servizi regolari a trecento chilometri "
         "orari tra le grandi città."),
        ("it-d15", "Durante il sonno profondo il cervello ripassa le "
         "esperienze della giornata e le consolida nella memoria a "
         "lungo termine. Gli studenti che dormono bene dopo lo studio "
         "ricordano meglio gli elenchi di parole."),
        ("it-d16", "I fari avvertivano i marinai degli scogli molto prima "
         "della navigazione satellitare. Una lente rotante concentrava "
         "la fiamma di una lampada a olio in un fascio dal lampo "
         "riconoscibile."),
        ("it-d17", "Gli impianti di dissalazione trasformano l'acqua di "
         "mare in acqua potabile spingendola ad alta pressione "
         "attraverso membrane a osmosi inversa. Il processo consuma "
         "molta elettricità, spesso fornita da campi solari."),
        ("it-d18", "Le comete sono corpi antichi di ghiaccio e polvere "
         "che girano intorno al sole su orbite molto allungate. Vicino "
         "al perielio il gas che sfugge forma la coda luminosa rivolta "
         "in direzione opposta al sole."),
        ("it-d19", "Una turbina eolica trasforma il movimento dell'aria "
         "in elettricità con un moltiplicatore e un generatore in cima "
         "a una torre. I parchi in mare godono di venti più costanti "
         "dei siti a terra."),
    ],
    "ar": [
        ("ar-d00", "يجمع النحل الرحيق من النباتات المزهرة وينقل أثناء "
         "ذلك حبوب اللقاح من زهرة إلى أخرى. تعتمد محاصيل كثيرة من "
         "الفاكهة على هذا التلقيح، ولذلك ينقل مربو النحل خلاياهم بين "
         "البساتين في موسم الإزهار."),
        ("ar-d01", "تتراجع الأنهار الجليدية في جبال الألب منذ منتصف "
         "القرن التاسع عشر. وتظهر مقارنة الصور القديمة بالقياسات "
         "الحديثة أن كثيرا من الألسنة الجليدية فقدت أكثر من نصف "
         "طولها."),
        ("ar-d02", "بدأت الثورة الصناعية في مصانع غزل القطن حيث كانت "
         "العجلات المائية ثم المحركات البخارية تدير الآلات. وأصبح "
         "القماش الذي كان ينسج يدويا يخرج فجأة من مصانع ضخمة."),
        ("ar-d03", "تحدث عملية التركيب الضوئي في البلاستيدات الخضراء "
         "داخل الأوراق، حيث يثبت ضوء الشمس ثاني أكسيد الكربون في صورة "
         "سكر. والأكسجين المنطلق يدعم معظم الحياة الحيوانية على "
         "الكوكب."),
        ("ar-d04", "تتفاعل أسواق الأسهم بسرعة مع قرارات البنوك "
         "المركزية. فعندما يعلن رفع غير متوقع لأسعار الفائدة يصبح "
         "الاقتراض أغلى وتهبط أسهم الشركات المثقلة بالديون خلال "
         "دقائق."),
        ("ar-d05", "يخزن الحاسوب الكمي المعلومات في كيوبتات يمكنها أن "
         "تتراكب بين الصفر والواحد. والخوارزميات التي تستغل هذه "
         "الحالات تحلل الأعداد إلى عواملها أسرع بكثير من الحواسيب "
         "التقليدية."),
        ("ar-d06", "بنى المهندسون الرومان قنوات مائية تعبر الوديان على "
         "جسور حجرية ذات أقواس. وكان الانحدار اللطيف المقاس بعناية "
         "يبقي الماء جاريا من ينابيع الجبال إلى النوافير العامة."),
        ("ar-d07", "تبيض الشعاب المرجانية عندما تجبر مياه البحر شديدة "
         "الدفء البوليبات على طرد الطحالب المتعايشة معها. ومن دون "
         "الطحالب يفقد المرجان لونه ومصدر غذائه الرئيسي."),
        ("ar-d08", "انتشرت الطباعة بالحروف المتحركة في أوروبا في أواخر "
         "القرن الخامس عشر. فالكتب التي كان نسخها باليد يستغرق شهورا "
         "صارت تطبع في أيام، ورخص سعر القراءة."),
        ("ar-d09", "تفقد المضادات الحيوية فعاليتها عندما تطور "
         "البكتيريا مقاومة لها. والإفراط في استعمالها في الطب وتربية "
         "الماشية يسرع هذه العملية، ولذلك ينصح الأطباء بالترشيد في "
         "الوصف."),
        ("ar-d10", "نشأت موسيقى الجاز من الراغتايم والبلوز في قاعات "
         "الرقص في نيو أورلينز حيث كانت الفرق النحاسية ترتجل على "
         "إيقاعات متقطعة. وحملت الأسطوانات هذه الموسيقى إلى شيكاغو ثم "
         "إلى العالم."),
        ("ar-d11", "تشكل سحب الرماد البركاني خطرا كبيرا على الطيران "
         "لأن الجسيمات الزجاجية الدقيقة تنصهر داخل المحركات النفاثة. "
         "وبعد أي ثوران كبير تحول مسارات الرحلات بعيدا عن العمود "
         "الرمادي."),
        ("ar-d12", "نشأت لعبة الشطرنج في شمال الهند بوصفها لعبة حرب "
         "على رقعة من أربع وستين مربعا. ونقلها التجار عبر بلاد فارس "
         "إلى أوروبا حيث استقرت حركات الوزير والفيل الحديثة."),
        ("ar-d13", "يعصر زيت الزيتون من ثمار شجرة تزدهر في صيف البحر "
         "المتوسط الجاف. وتعطي العصرة الأولى على البارد أجود درجة، "
         "بينما توجه العصرات اللاحقة إلى التكرير."),
        ("ar-d14", "تسير القطارات فائقة السرعة على مسارات مخصصة ذات "
         "منحنيات لطيفة ومن غير معابر أرضية. ويتيح الجر الكهربائي "
         "رحلات منتظمة بسرعة ثلاثمئة كيلومتر في الساعة بين المدن "
         "الكبرى."),
        ("ar-d15", "أثناء النوم العميق يعيد الدماغ عرض تجارب اليوم "
         "ويثبتها في الذاكرة طويلة الأمد. والطلاب الذين ينامون جيدا "
         "بعد المذاكرة يتذكرون قوائم الكلمات أفضل ممن يسهرون الليل."),
        ("ar-d16", "كانت المنارات تحذر البحارة من الصخور قبل ظهور "
         "الملاحة بالأقمار الصناعية بزمن طويل. وكانت عدسة دوارة تركز "
         "لهب مصباح الزيت في حزمة ضوئية لكل محطة وميض مميز."),
        ("ar-d17", "تحول محطات التحلية ماء البحر إلى ماء صالح للشرب "
         "بدفعه تحت ضغط عال عبر أغشية التناضح العكسي. وتستهلك العملية "
         "كهرباء كثيرة، ولذلك تقرن المدن الساحلية الجافة محطاتها "
         "بمزارع شمسية."),
        ("ar-d18", "المذنبات أجسام قديمة من جليد وغبار تدور حول الشمس "
         "في مدارات إهليلجية ممدودة. وقرب الحضيض يبخر ضوء الشمس سطحها "
         "فيكون الغاز المتسرب الذيل اللامع المتجه بعيدا عن الشمس."),
        ("ar-d19", "تحول توربينات الرياح حركة الهواء إلى كهرباء عبر "
         "علبة تروس ومولد مثبتين في أعلى برج. وتلتقط المزارع البحرية "
         "رياحا أكثر انتظاما من مواقع اليابسة لكن صيانتها في البحر "
         "أصعب."),
    ],
    "ko": [
        ("ko-d00", "꿀벌은 꽃이 핀 식물에서 꿀을 모으면서 꽃가루를 꽃에서 "
         "꽃으로 옮긴다. 많은 과일 작물이 이 수분에 의존하기 때문에 "
         "양봉가들은 개화기에 벌통을 과수원 사이로 옮긴다."),
        ("ko-d01", "알프스의 빙하는 십구 세기 중반부터 계속 후퇴하고 있다. "
         "오래된 사진과 현대 측량을 비교하면 많은 빙하 혀가 길이의 절반 "
         "이상을 잃었음을 알 수 있다."),
        ("ko-d02", "산업 혁명은 면직물 방적 공장에서 시작되었다. 물레방아와 "
         "증기 기관이 방적 기계를 돌리면서 손으로 짜던 천이 갑자기 거대한 "
         "공장에서 생산되었다."),
        ("ko-d03", "광합성은 녹색 잎의 엽록체에서 일어나며 햇빛이 물을 "
         "분해하고 이산화탄소를 당으로 고정한다. 부산물로 나오는 산소가 "
         "지구상 거의 모든 동물의 생명을 지탱한다."),
        ("ko-d04", "주식 시장은 중앙은행의 결정에 빠르게 반응한다. 예상치 "
         "못한 금리 인상이 발표되면 대출 비용이 올라가고 부채가 많은 "
         "기업의 주가는 몇 분 안에 떨어진다."),
        ("ko-d05", "양자 컴퓨터는 영과 일의 중첩 상태를 가질 수 있는 "
         "큐비트에 정보를 저장한다. 이 상태들의 간섭을 이용하는 "
         "알고리즘은 고전 컴퓨터보다 훨씬 빠르게 수를 소인수분해한다."),
        ("ko-d06", "로마의 기술자들은 아치형 돌다리 위로 신선한 물을 "
         "나르는 수도교를 건설했다. 세심하게 측량된 완만한 경사 덕분에 "
         "물은 산속 샘에서 공공 분수까지 수십 킬로미터를 흘렀다."),
        ("ko-d07", "산호초는 비정상적으로 따뜻한 바닷물 때문에 폴립이 "
         "공생 조류를 내보내면 하얗게 백화한다. 조류가 없으면 산호는 "
         "색과 주요 먹이 공급원을 모두 잃는다."),
        ("ko-d08", "금속 활자 인쇄술은 십오 세기 말 유럽 전역으로 빠르게 "
         "퍼졌다. 손으로 베끼는 데 몇 달 걸리던 책이 며칠 만에 인쇄되었고 "
         "책값이 내려가며 글을 읽는 사람이 늘었다."),
        ("ko-d09", "항생제는 세균이 내성을 진화시키면 효과를 잃는다. "
         "의료와 축산에서의 남용이 이 과정을 가속하므로 의사들은 꼭 "
         "필요할 때만 처방하도록 권고받는다."),
        ("ko-d10", "재즈는 뉴올리언스의 무도회장에서 래그타임과 블루스로부터 "
         "성장했다. 금관 악단이 당김음 리듬 위에서 즉흥 연주를 했고 음반이 "
         "이 새로운 음악을 시카고와 전 세계로 실어 날랐다."),
        ("ko-d11", "화산재 구름은 미세한 유리질 입자가 제트 엔진 안에서 "
         "녹기 때문에 항공에 심각한 위험이 된다. 큰 분화가 일어나면 "
         "항공편은 연기 기둥을 우회하고 바람이 닿는 공항은 며칠씩 닫힌다."),
        ("ko-d12", "체스는 북인도에서 팔 곱하기 팔 판 위에서 하는 전쟁 "
         "놀이로 시작되었다. 상인들이 페르시아를 거쳐 유럽으로 전했고 "
         "르네상스 시기에 퀸과 비숍의 현대적 행마가 정해졌다."),
        ("ko-d13", "올리브 기름은 지중해의 건조한 여름에 잘 자라는 나무의 "
         "열매를 눌러 짠다. 첫 번째 저온 압착이 가장 좋은 등급을 내고 "
         "열을 가한 추출은 정제용 기름이 된다."),
        ("ko-d14", "고속 열차는 완만한 곡선에 건널목이 없는 전용 선로를 "
         "달린다. 전기 견인과 공기역학 설계 덕분에 대도시 사이를 시속 "
         "삼백 킬로미터로 정기 운행할 수 있다."),
        ("ko-d15", "깊은 잠을 자는 동안 뇌는 낮의 경험을 재생하며 장기 "
         "기억으로 굳힌다. 공부한 뒤 잘 잔 학생은 밤을 새운 학생보다 "
         "단어 목록을 더 잘 기억한다."),
        ("ko-d16", "등대는 위성 항법이 생기기 훨씬 전부터 뱃사람에게 "
         "암초를 경고했다. 회전하는 렌즈가 기름 등잔의 불꽃을 광선으로 "
         "모았고 각 등대는 배가 알아볼 수 있는 고유한 깜박임을 냈다."),
        ("ko-d17", "해수 담수화 설비는 높은 압력으로 바닷물을 역삼투막에 "
         "통과시켜 마실 물을 만든다. 이 공정은 전기를 많이 쓰므로 건조한 "
         "해안 도시는 설비를 태양광 발전소와 함께 짓는 일이 많다."),
        ("ko-d18", "혜성은 길게 늘어난 타원 궤도로 태양을 도는 얼음과 "
         "먼지의 오래된 천체다. 근일점에 가까워지면 햇빛이 표면을 "
         "증발시키고 빠져나온 기체가 태양 반대쪽을 가리키는 밝은 꼬리를 "
         "만든다."),
        ("ko-d19", "풍력 터빈은 탑 꼭대기의 기어박스와 발전기를 거쳐 "
         "공기의 움직임을 전기로 바꾼다. 해상 풍력 단지는 육지보다 "
         "꾸준한 바람을 받지만 바다 위 정비는 더 어렵다."),
    ],
}

# {lang: [(query, target_doc_id), ...]}
REAL_QUERIES: Dict[str, List[Tuple[str, str]]] = {
    "en": [
        ("why do beekeepers move hives between orchards", "en-d00"),
        ("how much length have alpine glaciers lost", "en-d01"),
        ("steam engines in textile factories", "en-d02"),
        ("oxygen released by chloroplasts during photosynthesis", "en-d03"),
        ("effect of interest rate increase on share prices", "en-d04"),
        ("qubits superposition factoring numbers", "en-d05"),
        ("bleaching of coral when seawater warms", "en-d07"),
        ("bacteria evolving resistance to antibiotics", "en-d09"),
        ("volcanic ash melting inside jet engines", "en-d11"),
        ("reverse osmosis membranes for seawater drinking water", "en-d17"),
    ],
    "fr": [
        ("pourquoi les apiculteurs déplacent leurs ruches", "fr-d00"),
        ("recul des glaciers alpins depuis le dix-neuvième siècle",
         "fr-d01"),
        ("machine à vapeur dans les filatures de coton", "fr-d02"),
        ("hausse des taux d'intérêt et chute des actions", "fr-d04"),
        ("qubits et superposition dans un ordinateur quantique", "fr-d05"),
        ("aqueducs romains ponts en arches", "fr-d06"),
        ("blanchissement du corail eau trop chaude", "fr-d07"),
        ("résistance des bactéries aux antibiotiques", "fr-d09"),
        ("cendres volcaniques danger pour les réacteurs d'avion", "fr-d11"),
        ("dessalement de l'eau de mer par osmose inverse", "fr-d17"),
    ],
    "de": [
        ("warum stellen Imker ihre Bienenstöcke um", "de-d00"),
        ("Rückzug der Alpengletscher seit dem neunzehnten Jahrhundert",
         "de-d01"),
        ("Dampfmaschinen in Baumwollspinnereien", "de-d02"),
        ("Zinserhöhung Wirkung auf Aktienkurse", "de-d04"),
        ("Qubits Überlagerung Quantencomputer", "de-d05"),
        ("römische Aquädukte Bogenbrücken Gefälle", "de-d06"),
        ("Korallenbleiche durch warmes Meerwasser", "de-d07"),
        ("Resistenz von Bakterien gegen Antibiotika", "de-d09"),
        ("Vulkanasche Gefahr für Triebwerke", "de-d11"),
        ("Meerwasserentsalzung mit Umkehrosmose", "de-d17"),
    ],
    "es": [
        ("por qué los apicultores mueven las colmenas", "es-d00"),
        ("retroceso de los glaciares alpinos", "es-d01"),
        ("máquinas de vapor en las hilanderías de algodón", "es-d02"),
        ("subida de tipos de interés y caída de las acciones", "es-d04"),
        ("qubits y superposición en un ordenador cuántico", "es-d05"),
        ("acueductos romanos puentes con arcos", "es-d06"),
        ("blanqueamiento del coral por agua cálida", "es-d07"),
        ("resistencia de las bacterias a los antibióticos", "es-d09"),
        ("ceniza volcánica peligro para los motores de avión", "es-d11"),
        ("desalinización del agua de mar por ósmosis inversa", "es-d17"),
    ],
    "it": [
        ("perché gli apicoltori spostano le arnie", "it-d00"),
        ("arretramento dei ghiacciai alpini", "it-d01"),
        ("macchine a vapore nelle filande di cotone", "it-d02"),
        ("rialzo dei tassi di interesse e calo dei titoli", "it-d04"),
        ("qubit e sovrapposizione nel computer quantistico", "it-d05"),
        ("acquedotti romani ponti ad arcate", "it-d06"),
        ("sbiancamento del corallo per acqua troppo calda", "it-d07"),
        ("resistenza dei batteri agli antibiotici", "it-d09"),
        ("cenere vulcanica pericolo per i motori a reazione", "it-d11"),
        ("dissalazione dell'acqua di mare a osmosi inversa", "it-d17"),
    ],
    "ar": [
        ("لماذا ينقل مربو النحل خلاياهم بين البساتين", "ar-d00"),
        ("تراجع الأنهار الجليدية في جبال الألب", "ar-d01"),
        ("المحركات البخارية في مصانع غزل القطن", "ar-d02"),
        ("أثر رفع أسعار الفائدة على أسهم الشركات", "ar-d04"),
        ("الكيوبتات والتراكب في الحاسوب الكمي", "ar-d05"),
        ("القنوات المائية الرومانية والجسور الحجرية", "ar-d06"),
        ("ابيضاض الشعاب المرجانية بسبب دفء المياه", "ar-d07"),
        ("مقاومة البكتيريا للمضادات الحيوية", "ar-d09"),
        ("خطر الرماد البركاني على المحركات النفاثة", "ar-d11"),
        ("تحلية ماء البحر بالتناضح العكسي", "ar-d17"),
    ],
    "ko": [
        ("양봉가들이 벌통을 과수원 사이로 옮기는 이유", "ko-d00"),
        ("알프스 빙하의 후퇴", "ko-d01"),
        ("방적 공장의 증기 기관", "ko-d02"),
        ("금리 인상이 주가에 미치는 영향", "ko-d04"),
        ("큐비트 중첩 양자 컴퓨터", "ko-d05"),
        ("로마 수도교 아치형 돌다리", "ko-d06"),
        ("따뜻한 바닷물로 인한 산호 백화", "ko-d07"),
        ("세균의 항생제 내성", "ko-d09"),
        ("화산재가 제트 엔진에 주는 위험", "ko-d11"),
        ("역삼투로 바닷물을 담수화", "ko-d17"),
    ],
}

LANGS = tuple(sorted(REAL_DOCS))


def real_eval_corpus():
    """(docs, docids, langs, queries, qlangs, positives) flattened across
    the seven languages — the shape the bench/test harness consumes."""
    docs, docids, dlangs = [], [], []
    queries, qlangs, positives = [], [], []
    for lang in LANGS:
        for did, text in REAL_DOCS[lang]:
            docs.append(text)
            docids.append(did)
            dlangs.append(lang)
        for qtext, target in REAL_QUERIES[lang]:
            queries.append(qtext)
            qlangs.append(lang)
            positives.append(target)
    return docs, docids, dlangs, queries, qlangs, positives
